"""TimeMamba video encoder: CLIP-ViT with bidirectional Mamba temporal
adapters (counterpart of the JAX package's ``models/timemamba.py``:
``Mlp``, ``SpaceTimeBlock``, ``TimeMamba``).

Input (B, T, H, W, 3); output (B, output_dim) fp32.
The cls token travels as (B, 1, D) and the patch grid as (B, n, t, D),
patch-major, so the temporal Mamba runs on (B·n, t, D) with a reshape.
Dropout (``drop_rate``) and drop-path (``drop_path_rate``) act in training
mode only, with masks drawn from the ``torch.Generator`` passed to
``forward``; at rate 0 and in eval mode they are the identity.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .common import (
    Dense,
    FusedMHA,
    LayerNorm,
    PatchifyConv,
    dropout,
    resolve_device,
)
from .mamba import MambaVim

ATTENTION_STYLES = ("frozen-in-time", "timesformer-div", "frozen-joint")


class Mlp(nn.Module):
    """fc1 → GELU → dropout → fc2 → dropout. GELU takes the tanh form under
    bf16 and the exact erf form otherwise, as the JAX package does.
    ``generator`` draws the initial weights; ``forward``'s draws the
    dropout masks."""

    def __init__(self, dim: int, hidden: int, *, drop: float = 0.0,
                 dtype: Optional[torch.dtype], generator: torch.Generator):
        super().__init__()
        self.drop = drop
        self.fc1 = Dense(dim, hidden, dtype=dtype, generator=generator)
        self.fc2 = Dense(hidden, dim, dtype=dtype, generator=generator)
        self.approximate = "tanh" if dtype == torch.bfloat16 else "none"

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = F.gelu(self.fc1(x), approximate=self.approximate)
        x = dropout(x, self.drop, self.training, generator)
        return dropout(self.fc2(x), self.drop, self.training, generator)


class SpaceTimeBlock(nn.Module):
    """Temporal ViM Mamba per patch position, then spatial attention per
    frame with the cls token broadcast over frames and averaged back, then
    the MLP.

    attention_style: "frozen-in-time" (the temporal output feeds attention
    only; the residual is the block input), "timesformer-div" (the temporal
    residual stays in the stream) or "frozen-joint" (the Mamba scans the
    joint n·t sequence: the chunked scan, K3 on CUDA, whose backward is
    not ported yet).
    ``drop`` is the Mlp's dropout rate; ``drop_path`` drops the whole MLP
    branch (cls and patches together) per sample in training mode.
    ``attn_flash`` is the spatial attention's ``FusedMHA.flash``: None the
    einsum path, "row" the whole-row kernel K10 (one launch per block on
    CUDA).
    """

    def __init__(self, dim: int, num_heads: int, *,
                 drop: float = 0.0, drop_path: float = 0.0,
                 is_tanh_gating: bool = False,
                 attention_style: str = "frozen-in-time",
                 attn_flash=None,
                 dtype: Optional[torch.dtype] = None,
                 generator: torch.Generator):
        super().__init__()
        if attention_style not in ATTENTION_STYLES:
            raise ValueError(f"unknown attention_style {attention_style!r}")
        self.attention_style = attention_style
        self.drop_path = drop_path
        self.norm3 = LayerNorm(dim, dtype)
        self.time_mamba = MambaVim(d_model=dim, expand=1, dtype=dtype,
                                   device="cpu", generator=generator)
        self.alpha_timeattn = (nn.Parameter(torch.zeros(()))
                               if is_tanh_gating else None)
        self.norm1 = LayerNorm(dim, dtype)
        self.attn = FusedMHA(dim, num_heads, dtype=dtype, flash=attn_flash,
                             seq_axis=1, generator=generator)
        self.norm2 = LayerNorm(dim, dtype)
        self.mlp = Mlp(dim, 4 * dim, drop=drop, dtype=dtype,
                       generator=generator)

    def forward(self, cls: torch.Tensor, patches: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        """cls (B, 1, D); patches (B, n, t, D). Returns (cls, patches).
        ``generator`` draws the dropout and drop-path masks in training."""
        B, n, t, D = patches.shape
        if self.attention_style == "frozen-joint":
            ht = patches.reshape(B, n * t, D)
        else:
            ht = patches.reshape(B * n, t, D)
        time_out = self.time_mamba(self.norm3(ht))
        if self.alpha_timeattn is not None:
            time_out = torch.tanh(self.alpha_timeattn).to(time_out.dtype) \
                * time_out
        tr = (ht + time_out).reshape(B, n, t, D)

        cls4 = cls.to(patches.dtype)[:, :, None].expand(B, 1, t, D)
        xs = torch.cat([cls4, tr], dim=1)                  # (B, 1+n, t, D)
        space_out = self.attn(self.norm1(xs))
        cls = cls + space_out[:, 0].mean(dim=1, keepdim=True)
        base = tr if self.attention_style == "timesformer-div" else patches
        patches = base + space_out[:, 1:]
        mlp_cls = self.mlp(self.norm2(cls), generator)
        mlp_patch = self.mlp(self.norm2(patches), generator)
        if self.training and self.drop_path > 0.0:
            if generator is None:
                raise ValueError("drop-path in training mode needs a "
                                 "torch.Generator")
            # one decision per sample for the whole branch
            keep = 1.0 - self.drop_path
            mask = torch.rand(B, 1, 1, device=cls.device,
                              generator=generator) < keep
            mlp_cls = torch.where(mask, mlp_cls / keep, 0.0)
            mlp_patch = torch.where(mask[..., None], mlp_patch / keep, 0.0)
        return cls + mlp_cls, patches + mlp_patch


class TimeMamba(nn.Module):
    """Video encoder: patch embed → depth × SpaceTimeBlock → LayerNorm on
    the cls token → projection to ``output_dim``; with ``output_dim`` None
    there is no projection and the normed cls token (``embed_dim`` wide)
    comes out, as a classifier's backbone takes it.

    ``dtype`` is the compute dtype (parameters stay fp32); the final norm
    and projection run in fp32, as in the JAX package. Built on ``device``
    ("cuda" unless the caller asks for "cpu") from ``torch.Generator``
    seeded with ``seed``. ``drop_rate`` is the dropout after the patch
    embedding and in each Mlp; block i drops its MLP branch at
    ``drop_path_rate · i / (depth - 1)``, the JAX package's schedule.
    ``attn_flash`` goes to every block's spatial attention (see
    ``SpaceTimeBlock``).
    """

    def __init__(self, img_size: int = 224, patch_size: int = 16,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 num_frames: int = 8, ln_pre: bool = False,
                 is_tanh_gating: bool = False,
                 attention_style: str = "frozen-in-time",
                 output_dim: Optional[int] = 512, drop_rate: float = 0.0,
                 drop_path_rate: float = 0.0, attn_flash=None,
                 dtype: Optional[torch.dtype] = None, device="cuda",
                 seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        g = torch.Generator().manual_seed(seed)
        self.num_frames = num_frames
        self.embed_dim = embed_dim
        self.drop_rate = drop_rate
        self.patch_embed = PatchifyConv(3, embed_dim, patch_size,
                                        bias=not ln_pre, dtype=dtype,
                                        generator=g)
        n = (img_size // patch_size) ** 2
        self.cls_token = nn.Parameter(nn.init.trunc_normal_(
            torch.empty(1, 1, embed_dim), 0.0, 0.02, -0.04, 0.04,
            generator=g))
        self.pos_embed = nn.Parameter(nn.init.trunc_normal_(
            torch.empty(1, n + 1, embed_dim), 0.0, 0.02, -0.04, 0.04,
            generator=g))
        self.ln_pre = LayerNorm(embed_dim, dtype) if ln_pre else None
        self.blocks = nn.ModuleList(
            SpaceTimeBlock(embed_dim, num_heads, drop=drop_rate,
                           drop_path=drop_path_rate * i / max(depth - 1, 1),
                           is_tanh_gating=is_tanh_gating,
                           attention_style=attention_style,
                           attn_flash=attn_flash, dtype=dtype, generator=g)
            for i in range(depth))
        self.norm = LayerNorm(embed_dim)
        self.image_projection = None if output_dim is None else \
            nn.Parameter(nn.init.normal_(
                torch.empty(embed_dim, output_dim), 0.0, embed_dim ** -0.5,
                generator=g))
        self.to(device)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x (B, T, H, W, 3) → (B, output_dim) fp32 (``embed_dim`` without
        a projection). ``generator`` (on x's device) draws the dropout and
        drop-path masks in training mode."""
        B, T, H, W, C = x.shape
        feat = self.patch_embed(x.reshape(B * T, H, W, C))
        BT, hh, ww, D = feat.shape
        n = hh * ww
        feat = feat.reshape(BT, n, D)
        cls = self.cls_token.to(feat.dtype).expand(BT, 1, D)
        feat = torch.cat([cls, feat], dim=1) + self.pos_embed.to(feat.dtype)
        cls_tokens = feat[:B, :1]
        patches = feat[:, 1:].reshape(B, T, n, D).permute(0, 2, 1, 3)
        if self.ln_pre is not None:
            cls_tokens, patches = self.ln_pre(cls_tokens), self.ln_pre(patches)
        cls_tokens = dropout(cls_tokens, self.drop_rate, self.training,
                             generator)
        patches = dropout(patches, self.drop_rate, self.training, generator)
        for blk in self.blocks:
            cls_tokens, patches = blk(cls_tokens, patches, generator)
        h = self.norm(cls_tokens)[:, 0]                      # fp32
        if self.image_projection is None:
            return h
        return h @ self.image_projection

    def flops_per_clip(self) -> float:
        """Operations of one clip's forward (num_frames frames at the
        model's image size), counted from shapes: every matmul at 2·m·k·n,
        and the scan at 6 per state update and direction. Norms, softmax,
        GELU and the conv are left out."""
        frames = self.num_frames
        D = self.embed_dim
        n = self.pos_embed.shape[1] - 1
        in_k = self.patch_embed.weight.shape[1]
        total = 2.0 * frames * n * in_k * D               # patch embed
        tokens = n * frames                               # Mamba / MLP rows
        rows = (n + 1) * frames                           # attention rows
        for blk in self.blocks:
            vim = blk.time_mamba
            d_inner = vim.out_proj.weight.shape[1]
            dt_rank = vim.fwd.dt_proj.shape[1]
            d_state = vim.fwd.A_log.shape[1]
            heads = blk.attn.num_heads
            hidden = blk.mlp.fc1.weight.shape[0]
            total += 2.0 * tokens * D * 2 * d_inner       # in_proj
            total += 2 * 2.0 * tokens * d_inner * (dt_rank + 2 * d_state)
            total += 2 * 2.0 * tokens * dt_rank * d_inner  # dt_proj
            total += 2 * 6.0 * tokens * d_inner * d_state  # scan
            total += 2.0 * tokens * d_inner * D           # out_proj
            total += 2.0 * rows * D * 4 * D               # qkv + out
            total += 2 * 2.0 * frames * (n + 1) ** 2 * D  # scores, w·v
            total += 2 * 2.0 * (tokens + 1) * D * hidden  # fc1 + fc2
        if self.image_projection is not None:
            total += 2.0 * D * self.image_projection.shape[1]
        return total


def build_timemamba_b(device="cuda", dtype: Optional[torch.dtype]
                      = torch.bfloat16, seed: int = 0, attn_flash=None,
                      **overrides) -> TimeMamba:
    """TimeMamba-B (configs.TIMEMAMBA_B) with random weights from ``seed``.
    ``attn_flash`` picks the spatial attention's kernel (None: the einsum
    path; "row": K10); ``overrides`` change any other constructor argument,
    e.g. ``depth``."""
    from ..configs import TIMEMAMBA_B

    kw = dict(TIMEMAMBA_B, **overrides)
    return TimeMamba(**kw, attn_flash=attn_flash, dtype=dtype, device=device,
                     seed=seed)
