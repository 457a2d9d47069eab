"""UniVTG-Mamba, the cross-modal grounding model (the port's counterpart of
the JAX package's ``tasks/vtg/model.py``): LayerNorm → dropout → Dense
input projectors, a token-type embedding, one Mamba encoder over the
concatenated [text; video] sequence with the per-layer positions added
after the fused add-norm and before the mixer, a final fused norm, conv
heads for the foreground probability and the span offsets, and the
cosine saliency of the projected clips against the weighted-pooled
query.

The text is padded to a fixed ``max_q_l`` in the middle of the sequence;
its masked steps are identity elements of the scan (the JAX
``MASKED_DELTA`` rule, kept by the mixers). At more than 64 steps every
mixer scans through K3 on the card (K4 in the backward), at 64 or fewer
through K1 (K2).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...models.common import (
    Dense,
    Embedding,
    LayerNorm,
    MaskedConv1D,
    drop_path,
    dropout,
    init_weight,
    resolve_device,
    sinusoid_positions,
)
from ...models.mamba import MambaDBM, MambaVim
from ...models.rope import rope_rotate
from ...ops.norms import fused_add_norm


class LinearLayer(nn.Module):
    """LayerNorm (``norm``) → dropout → Dense (``dense``) → ReLU, the
    first and the last optional (the JAX ``LinearLayer``)."""

    def __init__(self, in_dim: int, out_dim: int, use_ln: bool = True,
                 dropout: float = 0.0, relu: bool = True, *,
                 generator: torch.Generator):
        super().__init__()
        self.rate, self.relu = dropout, relu
        self.norm = LayerNorm(in_dim) if use_ln else None
        self.dense = Dense(in_dim, out_dim, generator=generator)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        if self.norm is not None:
            x = self.norm(x)
        x = self.dense(dropout(x, self.rate, self.training, generator))
        return F.relu(x) if self.relu else x


class ConvHead(nn.Module):
    """``num_layers`` convolutions of width ``kernel_size`` over time with
    flax's SAME padding, ReLU between them (the JAX ``ConvHead``): every
    step is convolved, padded ones included. ``convs.{i}`` are
    ``MaskedConv1D``s used without a mask, their weights (out, in, k), the
    flax kernel (k, in, out) transposed, drawn as flax's ``nn.Conv``
    draws them (lecun normal)."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 num_layers: int = 3, kernel_size: int = 3, *,
                 generator: torch.Generator):
        super().__init__()
        self.convs = nn.ModuleList(
            MaskedConv1D(in_dim if i == 0 else hidden_dim,
                         out_dim if i == num_layers - 1 else hidden_dim,
                         kernel_size, generator=generator,
                         init="lecun_normal")
            for i in range(num_layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, L, C) → (B, L, out_dim)."""
        for i, conv in enumerate(self.convs):
            x = conv.conv(x)
            if i < len(self.convs) - 1:
                x = F.relu(x)
        return x


class WeightedPool(nn.Module):
    """Masked attention pooling over L (the JAX ``WeightedPool``): scores
    x @ ``weight`` (D, 1), -1e30 at masked steps, a softmax over L, the
    weighted sum of x, in fp32."""

    def __init__(self, dim: int, *, generator: torch.Generator):
        super().__init__()
        self.weight = nn.Parameter(init_weight(
            (dim, 1), "xavier_uniform", generator, fan_in=dim, fan_out=1))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """x (B, L, D), mask (B, L) → (B, D)."""
        x = x.float()
        alpha = torch.where(mask[..., None] > 0, x @ self.weight, -1e30)
        alphas = torch.softmax(alpha, dim=1)
        return (x * alphas).sum(dim=1)


def safe_norm(x: torch.Tensor, dim: int = -1,
              eps: float = 1e-8) -> torch.Tensor:
    """sqrt(Σx² + eps): a finite gradient at zero rows, which padded
    steps give (the JAX ``_safe_norm``)."""
    return torch.sqrt((x * x).sum(dim=dim) + eps)


def cosine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cosine over the last axis in fp32, the eps inside each norm."""
    a, b = a.float(), b.float()
    return (a * b).sum(dim=-1) / (safe_norm(a) * safe_norm(b))


class VtgLayer(nn.Module):
    """One encoder layer's prenorm parameters ``norm_w``, ``norm_b`` and
    its ``mixer`` (the JAX tree's ``norm{i}_w``, ``norm{i}_b``,
    ``mixer{i}``)."""

    def __init__(self, dim: int, mixer: nn.Module):
        super().__init__()
        self.norm_w = nn.Parameter(torch.ones(dim))
        self.norm_b = nn.Parameter(torch.zeros(dim))
        self.mixer = mixer


class UniVTGMamba(nn.Module):
    """The JAX ``UniVTGMamba``. ``forward(src_txt (B, Lt, Dt),
    src_txt_mask (B, Lt), src_vid (B, Lv, Dv), src_vid_mask (B, Lv))``
    returns the dict pred_logits (B, Lv, 1) (probabilities), pred_spans
    (B, Lv, 2), src_vid_mask, vid_mem_proj (the pre-encoder video
    projection), txt_mem_proj (B, 1, D) and saliency_scores (B, Lv), and
    cls_mem_proj (C, D) when class-name tokens ``src_cls`` (C, Lc, Dt)
    come with ``src_cls_mask``: they go through the text projector and
    the pool, not the encoder. In training mode the dropouts and
    drop-paths draw from ``generator``. Builds on ``device``, CUDA unless
    the caller passes "cpu"; initial weights from ``seed``."""

    def __init__(self, txt_dim: int, vid_dim: int, embed_dim: int = 1024,
                 depth: int = 6, n_input_proj: int = 2,
                 input_dropout: float = 0.5, drop_path_rate: float = 0.1,
                 mamba_type: str = "vim", if_rope: bool = False,
                 norm_eps: float = 1e-5, device="cuda", seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        if mamba_type not in ("vim", "dbm"):
            raise ValueError(f"unknown mamba_type {mamba_type!r}")
        g = torch.Generator().manual_seed(seed)
        self.embed_dim, self.depth = embed_dim, depth
        self.drop_path_rate, self.if_rope = drop_path_rate, if_rope
        self.norm_eps = norm_eps
        relu = [True] * 3
        relu[n_input_proj - 1] = False

        def projector(in_dim):
            return nn.ModuleList(
                LinearLayer(in_dim if i == 0 else embed_dim, embed_dim,
                            dropout=input_dropout, relu=relu[i],
                            generator=g)
                for i in range(n_input_proj))

        self.vid_proj = projector(vid_dim)
        self.txt_proj = projector(txt_dim)
        self.token_type = Embedding(2, embed_dim, generator=g)
        self.layers = nn.ModuleList()
        for _ in range(depth):
            if mamba_type == "vim":
                mixer = MambaVim(embed_dim, device="cpu", generator=g)
            else:
                mixer = MambaDBM(embed_dim, expand=1, device="cpu",
                                 generator=g)
            self.layers.append(VtgLayer(embed_dim, mixer))
        self.norm_f_w = nn.Parameter(torch.ones(embed_dim))
        self.norm_f_b = nn.Parameter(torch.zeros(embed_dim))
        self.class_embed = ConvHead(embed_dim, embed_dim, 1, generator=g)
        self.span_embed = ConvHead(embed_dim, embed_dim, 2, generator=g)
        self.weightedpool = WeightedPool(embed_dim, generator=g)
        self.to(device)

    @staticmethod
    def _project(layers, x, generator):
        for layer in layers:
            x = layer(x, generator)
        return x

    def forward(self, src_txt: torch.Tensor, src_txt_mask: torch.Tensor,
                src_vid: torch.Tensor, src_vid_mask: torch.Tensor,
                src_cls: Optional[torch.Tensor] = None,
                src_cls_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        vid = self._project(self.vid_proj, src_vid, generator)
        txt = self._project(self.txt_proj, src_txt, generator)
        Lt, Lv = txt.shape[1], vid.shape[1]
        types = torch.cat([
            torch.zeros_like(src_txt_mask, dtype=torch.long),
            torch.ones_like(src_vid_mask, dtype=torch.long)], dim=1)
        hidden = torch.cat([txt, vid], dim=1) + self.token_type(types)
        mask = torch.cat([src_txt_mask, src_vid_mask], dim=1)
        # positions: zeros over the text, the sinusoid table over the clips
        pos = torch.cat([
            torch.zeros(Lt, self.embed_dim, device=hidden.device),
            sinusoid_positions(Lv, self.embed_dim, device=hidden.device)])
        residual = None
        for i, layer in enumerate(self.layers):
            h_in = hidden
            if i > 0:
                h_in = drop_path(hidden, self.drop_path_rate, self.training,
                                 generator)
            if self.if_rope:
                h_in = rope_rotate(h_in)
            h, residual = fused_add_norm(
                h_in, layer.norm_w, layer.norm_b, residual=residual,
                prenorm=True, eps=self.norm_eps)
            hidden = layer.mixer(h + pos.to(h.dtype), mask)
        hidden, _ = fused_add_norm(
            hidden, self.norm_f_w, self.norm_f_b, residual=residual,
            prenorm=False, eps=self.norm_eps)

        vid_mem = hidden[:, Lt:Lt + Lv]
        class_prob = torch.sigmoid(self.class_embed(vid_mem))
        coord = torch.sigmoid(self.span_embed(vid_mem))
        pred_spans = coord * coord.new_tensor([-1.0, 1.0])
        txt_pool = self.weightedpool(txt, src_txt_mask)[:, None]
        sim = cosine(vid, txt_pool) + torch.where(src_vid_mask > 0, 0.0,
                                                  -1e4)
        out = dict(pred_logits=class_prob, pred_spans=pred_spans,
                   src_vid_mask=src_vid_mask, vid_mem_proj=vid,
                   txt_mem_proj=txt_pool, saliency_scores=sim)
        if src_cls is not None:
            cls = self._project(self.txt_proj, src_cls, generator)
            out["cls_mem_proj"] = self.weightedpool(cls, src_cls_mask)
        return out
