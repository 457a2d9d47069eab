"""1-D multi-scale deformable attention (the port's counterpart of the JAX
package's ``ops/deform_attn.py``; upstream PDVC's ``MSDeformAttn`` over
time).

The JAX package writes it in plain jnp, with no Pallas kernel: a linear
interpolation gathered from each level. Here it is plain torch with
``torch.gather``, on the card and on the CPU alike.

Sampling convention (align_corners=False, border padding): a normalized
location x in [0, 1] over a level of length T samples at x·T − 0.5; the
two neighbours are clamped to [0, T−1] after the interpolation weight is
taken, so the gradient to the location flows through that weight alone.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from ..models.common import Dense


def linear_sample_1d(value: torch.Tensor, loc: torch.Tensor) -> torch.Tensor:
    """value (B, T, C); loc (B, Q, P) normalized to [0, 1] → (B, Q, P, C),
    each location's linear interpolation of its two neighbours."""
    B, T, C = value.shape
    x = loc * T - 0.5
    x0 = torch.floor(x)
    w1 = (x - x0).reshape(B, -1, 1)
    i0 = x0.long()
    flat0 = i0.clamp(0, T - 1).reshape(B, -1, 1).expand(-1, -1, C)
    flat1 = (i0 + 1).clamp(0, T - 1).reshape(B, -1, 1).expand(-1, -1, C)
    g0 = torch.gather(value, 1, flat0)
    g1 = torch.gather(value, 1, flat1)
    out = g0 * (1 - w1) + g1 * w1
    return out.reshape(B, *loc.shape[1:], C)


def ms_deform_attn_core(value: torch.Tensor,
                        temporal_shapes: Sequence[int],
                        sampling_locations: torch.Tensor,
                        attention_weights: torch.Tensor) -> torch.Tensor:
    """value (B, ΣT_l, H, D) over the levels' lengths ``temporal_shapes``;
    sampling_locations and attention_weights (B, Q, H, L, P), the weights
    softmaxed over L·P → (B, Q, H·D), accumulated level by level in fp32
    at least."""
    B, S, H, D = value.shape
    Q = sampling_locations.shape[1]
    dtype = torch.promote_types(value.dtype, torch.float32)
    out = torch.zeros(B, Q, H, D, dtype=dtype, device=value.device)
    start = 0
    for level, T in enumerate(temporal_shapes):
        v = value[:, start:start + T].permute(0, 2, 1, 3).reshape(B * H, T, D)
        loc = sampling_locations[:, :, :, level].permute(0, 2, 1, 3)
        sampled = linear_sample_1d(v, loc.reshape(B * H, Q, -1))
        w = attention_weights[:, :, :, level].permute(0, 2, 1, 3)
        contrib = (sampled * w.reshape(B * H, Q, -1, 1)).sum(dim=2)
        out = out + contrib.reshape(B, H, Q, D).permute(0, 2, 1, 3)
        start += T
    return out.reshape(B, Q, H * D)


def directional_offset_bias(n_heads: int, n_levels: int,
                            n_points: int) -> torch.Tensor:
    """The reference's offset bias (H·L·P,): head h points along
    cos(2πh/H), scaled to a largest magnitude of 1, point p at p + 1 times
    that."""
    thetas = torch.arange(n_heads, dtype=torch.float32) * (
        2 * math.pi / n_heads)
    grid = torch.cos(thetas)
    grid = grid / grid.abs().max()
    grid = grid[:, None, None].repeat(1, n_levels, n_points)
    grid = grid * torch.arange(1, n_points + 1, dtype=torch.float32)
    return grid.reshape(-1)


class MSDeformAttn1D(nn.Module):
    """The JAX ``MSDeformAttn1D``: ``value_proj``, ``sampling_offsets``
    (zero weight, the directional bias), ``attention_weights`` (zero
    weight and bias) and ``output_proj``. ``forward(query (B, Q, C),
    reference_points (B, Q, L, 1 or 2) in [0, 1], input_flatten (B, ΣT,
    C), temporal_shapes, input_padding_mask (B, ΣT) True at padding)``:
    with 1-wide references the offsets are in steps of each level, with
    (center, length) boxes in halves of the length over P."""

    def __init__(self, d_model: int = 256, n_levels: int = 4,
                 n_heads: int = 8, n_points: int = 4, *,
                 generator: torch.Generator):
        super().__init__()
        self.n_levels, self.n_heads, self.n_points = (n_levels, n_heads,
                                                      n_points)
        hlp = n_heads * n_levels * n_points
        self.value_proj = Dense(d_model, d_model, generator=generator)
        self.sampling_offsets = Dense(d_model, hlp, generator=generator)
        self.attention_weights = Dense(d_model, hlp, generator=generator)
        self.output_proj = Dense(d_model, d_model, generator=generator)
        with torch.no_grad():
            self.sampling_offsets.weight.zero_()
            self.sampling_offsets.bias.copy_(
                directional_offset_bias(n_heads, n_levels, n_points))
            self.attention_weights.weight.zero_()

    def forward(self, query: torch.Tensor, reference_points: torch.Tensor,
                input_flatten: torch.Tensor, temporal_shapes: Sequence[int],
                input_padding_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        B, Q, _ = query.shape
        H, L, P = self.n_heads, self.n_levels, self.n_points
        value = self.value_proj(input_flatten)
        if input_padding_mask is not None:
            value = torch.where(input_padding_mask[..., None], 0.0, value)
        value = value.reshape(B, value.shape[1], H, -1)
        offsets = self.sampling_offsets(query).reshape(B, Q, H, L, P)
        weights = self.attention_weights(query).reshape(B, Q, H, L * P)
        weights = torch.softmax(weights, dim=-1).reshape(B, Q, H, L, P)
        ref = reference_points[:, :, None, :, None, 0]
        if reference_points.shape[-1] == 1:
            shapes = torch.tensor(list(temporal_shapes), dtype=torch.float32,
                                  device=query.device)
            loc = ref + offsets / shapes[None, None, None, :, None]
        else:                       # (center, length) reference boxes
            loc = (ref + offsets / P
                   * reference_points[:, :, None, :, None, 1] * 0.5)
        out = ms_deform_attn_core(value, list(temporal_shapes), loc, weights)
        return self.output_proj(out.to(query.dtype))
