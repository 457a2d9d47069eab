"""ViViM: a pure vision-Mamba video backbone with the cls token at the
middle patch position (counterpart of the JAX package's
``models/vivim.py``: ``PatchEmbed``, ``ViViM``, ``vivim_tiny``,
``vivim_small``).

Each frame is patch-embedded, the cls token goes in at the middle patch
index, and the position and per-frame temporal embeddings are added; the
frames are flattened into one (frames · tokens) sequence that runs through
ViM layers (prenorm add + norm, drop-path, a bidirectional Mamba mixer),
a final add + norm, and the mean over the per-frame cls positions, with an
optional projection and classification head.

There is no ``dtype``: the JAX model computes in fp32 whatever the input's
dtype (flax promotion with fp32 parameters), and so does this one. The
JAX-only ``scan_blocks``, ``remat`` and ``dual_stream`` are not ported
(numerically the plain layer loop). Built on ``device`` ("cuda" unless the
caller asks for "cpu") from a ``torch.Generator`` seeded with ``seed``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.norms import fused_add_norm
from .common import Dense, PatchifyConv, dropout, drop_path, resolve_device
from .mamba import MambaScanNorm, MambaVim

MIXERS = {"vim": MambaVim, "scan_norm": MambaScanNorm}


class PatchEmbed(nn.Module):
    """Stride-p patchifier with a bias: (N, H, W, C) → (N, tokens, D)."""

    def __init__(self, patch_size: int, embed_dim: int, in_chans: int = 3,
                 *, generator: torch.Generator):
        super().__init__()
        self.proj = PatchifyConv(in_chans, embed_dim, patch_size, bias=True,
                                 generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.proj(x)
        N, hh, ww, D = out.shape
        return out.reshape(N, hh * ww, D)


class ViViMLayer(nn.Module):
    """One ViM layer: drop-path on the incoming hidden state, the prenorm
    residual add + norm (weights ``norm_w``, ``norm_b``), then the mixer.
    Returns (mixer output, new residual in fp32)."""

    def __init__(self, dim: int, *, rms_norm: bool, norm_eps: float,
                 d_state: int, if_devide_out: bool, mixer: str,
                 drop_path: float, generator: torch.Generator):
        super().__init__()
        self.rms_norm = rms_norm
        self.norm_eps = norm_eps
        self.drop_path = drop_path
        self.norm_w = nn.Parameter(torch.ones(dim))
        self.norm_b = None if rms_norm else nn.Parameter(torch.zeros(dim))
        self.mixer = MIXERS[mixer](d_model=dim, d_state=d_state,
                                   if_devide_out=if_devide_out,
                                   device="cpu", generator=generator)

    def forward(self, hidden: torch.Tensor,
                residual: Optional[torch.Tensor],
                generator: Optional[torch.Generator] = None,
                flip: bool = False):
        hidden = drop_path(hidden, self.drop_path, self.training, generator)
        h, res = fused_add_norm(hidden, self.norm_w, self.norm_b,
                                residual=residual, prenorm=True,
                                eps=self.norm_eps,
                                is_rms_norm=self.rms_norm)
        if flip:
            h = torch.flip(h, dims=(1,))
        return self.mixer(h), res


class ViViM(nn.Module):
    """Videos (B, T, H, W, C) → (B, embed_dim or output_dim) features (the
    mean of the per-frame cls positions) or, with ``num_classes``,
    (B, num_classes) logits; fp32.

    ``if_bidirectional`` runs the layers in interleaved pairs: the second
    of a pair scans the flipped sequence, and the pair's outputs and
    residuals are summed. Dropout (``drop_rate``, after the embeddings)
    and drop-path (layer i at ``drop_path_rate · (i - 1) / (depth - 1)``,
    none on layer 0, the JAX schedule) act in training mode only, with
    masks from the ``torch.Generator`` passed to ``forward``.
    """

    def __init__(self, img_size: int = 224, patch_size: int = 16,
                 num_frames: int = 16, depth: int = 24,
                 embed_dim: int = 192, num_classes: int = 0,
                 output_dim: Optional[int] = None, drop_rate: float = 0.0,
                 drop_path_rate: float = 0.1, rms_norm: bool = False,
                 norm_eps: float = 1e-5, if_devide_out: bool = True,
                 if_bidirectional: bool = False, d_state: int = 16,
                 mixer: str = "vim", device="cuda", seed: int = 0):
        super().__init__()
        if mixer not in MIXERS:
            raise ValueError(f"unknown mixer {mixer!r}")
        device = resolve_device(device)
        g = torch.Generator().manual_seed(seed)
        self.num_frames = num_frames
        self.depth = depth
        self.embed_dim = embed_dim
        self.drop_rate = drop_rate
        self.rms_norm = rms_norm
        self.norm_eps = norm_eps
        self.if_bidirectional = if_bidirectional
        self.patch_embed = PatchEmbed(patch_size, embed_dim, generator=g)
        tokens = (img_size // patch_size) ** 2 + 1
        self.cls_token = nn.Parameter(nn.init.trunc_normal_(
            torch.empty(1, 1, embed_dim), 0.0, 0.02, -0.04, 0.04,
            generator=g))
        self.pos_embed = nn.Parameter(nn.init.trunc_normal_(
            torch.empty(1, tokens, embed_dim), 0.0, 0.02, -0.04, 0.04,
            generator=g))
        self.temporal_embed = (nn.Parameter(torch.zeros(num_frames, 1,
                                                        embed_dim))
                               if num_frames > 1 else None)
        dpr = [drop_path_rate * i / max(depth - 1, 1) for i in range(depth)]
        inter_dpr = [0.0] + dpr
        n_layers = 2 * (depth // 2) if if_bidirectional else depth
        self.layers = nn.ModuleList(
            ViViMLayer(embed_dim, rms_norm=rms_norm, norm_eps=norm_eps,
                       d_state=d_state, if_devide_out=if_devide_out,
                       mixer=mixer, drop_path=inter_dpr[i], generator=g)
            for i in range(n_layers))
        self.norm_f_w = nn.Parameter(torch.ones(embed_dim))
        self.norm_f_b = (None if rms_norm
                         else nn.Parameter(torch.zeros(embed_dim)))
        width = embed_dim
        self.image_projection = None
        if output_dim is not None:
            self.image_projection = nn.Parameter(nn.init.normal_(
                torch.empty(embed_dim, output_dim), 0.0,
                embed_dim ** -0.5, generator=g))
            width = output_dim
        self.head = (Dense(width, num_classes, generator=g)
                     if num_classes > 0 else None)
        self.to(device)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x (B, T, H, W, C) → features or logits. ``generator`` (on x's
        device) draws the dropout and drop-path masks in training mode."""
        B, T, H, W, C = x.shape
        feat = self.patch_embed(x.reshape(B * T, H, W, C))   # (BT, N, D)
        BT, N, D = feat.shape
        mid = N // 2
        cls = self.cls_token.to(feat.dtype).expand(BT, 1, D)
        feat = torch.cat([feat[:, :mid], cls, feat[:, mid:]], dim=1)
        M = N + 1
        feat = (feat + self.pos_embed.to(feat.dtype)).reshape(B, T, M, D)
        if self.temporal_embed is not None:
            feat = feat + self.temporal_embed[None, :T].to(feat.dtype)
        hidden = feat.reshape(B, T * M, D)
        hidden = dropout(hidden, self.drop_rate, self.training, generator)

        residual = None
        if not self.if_bidirectional:
            for layer in self.layers:
                hidden, residual = layer(hidden, residual, generator)
        else:
            for i in range(0, len(self.layers), 2):
                h_f, r_f = self.layers[i](hidden, residual, generator)
                h_b, r_b = self.layers[i + 1](hidden, residual, generator,
                                              flip=True)
                hidden = h_f + torch.flip(h_b, dims=(1,))
                residual = r_f + torch.flip(r_b, dims=(1,))
        hidden, _ = fused_add_norm(hidden, self.norm_f_w, self.norm_f_b,
                                   residual=residual, prenorm=False,
                                   eps=self.norm_eps,
                                   is_rms_norm=self.rms_norm)
        cls_positions = torch.arange(T, device=hidden.device) * M + mid
        feats = hidden[:, cls_positions].mean(dim=1)         # (B, D)
        if self.image_projection is not None:
            feats = feats @ self.image_projection.to(feats.dtype)
        if self.head is not None:
            feats = self.head(feats)
        return feats

    def flops_per_clip(self) -> float:
        """Operations of one clip's forward (num_frames frames at the
        model's image size), counted from shapes: every matmul at 2·m·k·n,
        and the scan at 6 per state update and direction. Norms, the conv,
        the gates and the softplus are left out."""
        frames = self.num_frames
        D = self.embed_dim
        tokens = self.pos_embed.shape[1]
        L = frames * tokens                               # sequence length
        in_k = self.patch_embed.proj.weight.shape[1]
        total = 2.0 * frames * (tokens - 1) * in_k * D    # patch embed
        for layer in self.layers:
            vim = layer.mixer
            d_inner = vim.out_proj.weight.shape[1]
            dt_rank = vim.fwd.dt_proj.shape[1]
            d_state = vim.fwd.A_log.shape[1]
            total += 2.0 * L * D * 2 * d_inner            # in_proj
            total += 2 * 2.0 * L * d_inner * (dt_rank + 2 * d_state)
            total += 2 * 2.0 * L * dt_rank * d_inner      # dt_proj
            total += 2 * 6.0 * L * d_inner * d_state      # scan
            total += 2.0 * L * d_inner * D                # out_proj
        width = D
        if self.image_projection is not None:
            width = self.image_projection.shape[1]
            total += 2.0 * D * width
        if self.head is not None:
            total += 2.0 * width * self.head.weight.shape[0]
        return total


def vivim_tiny(**kw) -> ViViM:
    """ViViM-T: width 192, 24 layers."""
    return ViViM(embed_dim=192, depth=24, **kw)


def vivim_small(**kw) -> ViViM:
    """ViViM-S: width 384, 24 layers."""
    return ViViM(embed_dim=384, depth=24, **kw)


def build_vivim_tiny_k400(device="cuda", seed: int = 0, **overrides
                          ) -> ViViM:
    """ViViM-T for Kinetics-400 (configs.VIVIM_T_K400) with random weights
    from ``seed``. ``overrides`` change any constructor argument, e.g.
    ``depth`` or ``mixer="scan_norm"``."""
    from ..configs import VIVIM_T_K400

    return ViViM(**dict(VIVIM_T_K400, **overrides), device=device, seed=seed)
