"""Building blocks of the towers and the LM (counterparts of the JAX
package's ``models/common.py``: ``make_dense``, ``PatchifyConv``,
``FusedMHA``, ``W8Embed``, ``sinusoid_positions``, and flax's
``nn.LayerNorm``).

Every block follows the JAX package's dtype policy: parameters stay fp32
and ``dtype`` is the compute dtype (None promotes the input with the
parameters, as flax does). Weights are in torch's (out, in) layout.
Initial values come from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def resolve_device(device) -> torch.device:
    """The device to build on. A CUDA device must exist: an entry point
    never falls back to the CPU unless the caller asks for it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the port's plain versions on the CPU")
    return device


def init_weight(shape, kind: str, generator: torch.Generator,
                fan_in: Optional[int] = None,
                fan_out: Optional[int] = None) -> torch.Tensor:
    """fp32 tensor of ``shape`` drawn on the CPU by the flax/torch rule
    ``kind``: "lecun_normal" (flax's default Dense and Conv init),
    "xavier_uniform", or "torch_linear" (torch nn.Linear's U(±1/√fan_in))."""
    w = torch.empty(shape, dtype=torch.float32)
    if kind == "lecun_normal":
        # flax variance_scaling(1, fan_in, truncated_normal): the std of a
        # normal truncated at ±2σ is 0.8796σ, so σ is scaled up by that
        std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
        return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                     generator=generator)
    if kind == "xavier_uniform":
        bound = math.sqrt(6.0 / (fan_in + fan_out))
        return nn.init.uniform_(w, -bound, bound, generator=generator)
    if kind == "torch_linear":
        bound = 1.0 / math.sqrt(fan_in)
        return nn.init.uniform_(w, -bound, bound, generator=generator)
    raise ValueError(f"unknown init {kind!r}")


def _compute_dtype(dtype, *tensors) -> torch.dtype:
    if dtype is not None:
        return dtype
    out = tensors[0].dtype
    for t in tensors[1:]:
        out = torch.promote_types(out, t.dtype)
    return out


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout``: each element kept with probability 1 - rate and
    scaled by 1 / (1 - rate), the mask drawn from ``generator`` (on x's
    device). The identity in eval mode and at rate 0."""
    if not training or rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    if generator is None:
        raise ValueError("dropout in training mode needs a torch.Generator")
    keep = 1.0 - rate
    mask = torch.rand(x.shape, device=x.device, generator=generator) < keep
    return torch.where(mask, x / keep, 0.0)


def drop_path(x: torch.Tensor, rate: float, training: bool,
              generator: Optional[torch.Generator]) -> torch.Tensor:
    """The JAX ``DropPath``: each sample (index of axis 0) kept whole with
    probability 1 - rate and scaled by 1 / (1 - rate), the mask drawn from
    ``generator`` (on x's device). The identity in eval mode and at rate
    0."""
    if not training or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("drop-path in training mode needs a "
                         "torch.Generator")
    keep = 1.0 - rate
    mask = torch.rand((x.shape[0],) + (1,) * (x.dim() - 1), device=x.device,
                      generator=generator) < keep
    return torch.where(mask, x / keep, 0.0)


def sinusoid_positions(length: int, dim: int, device=None) -> torch.Tensor:
    """The standard sin/cos table (length, dim) in fp32 (the JAX
    ``sinusoid_positions``); dim must be even."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32,
                                 device=device) * -(math.log(10000.0) / dim))
    pe = torch.zeros(length, dim, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


class Dense(nn.Module):
    """flax ``nn.Dense``: weight (out, in), optional bias, input and
    parameters cast to the compute dtype before the product."""

    def __init__(self, in_features: int, out_features: int, *,
                 bias: bool = True, dtype: Optional[torch.dtype] = None,
                 init: str = "lecun_normal",
                 generator: torch.Generator):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(init_weight(
            (out_features, in_features), init, generator,
            fan_in=in_features, fan_out=out_features))
        self.bias = (nn.Parameter(torch.zeros(out_features)) if bias
                     else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _compute_dtype(self.dtype, x, self.weight)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class Embedding(nn.Module):
    """Token embedding (the JAX ``W8Embed`` without its int8 ``qscale``
    table, i.e. flax ``nn.Embed``): ``weight`` (num_embeddings, features)
    drawn from N(0, ``init_std``²); the lookup returns rows in the
    table's dtype."""

    def __init__(self, num_embeddings: int, features: int, *,
                 generator: torch.Generator, init_std: float = 0.02):
        super().__init__()
        self.weight = nn.Parameter(init_std * torch.randn(
            num_embeddings, features, generator=generator))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: eps 1e-6, statistics and affine in fp32, the
    result cast to ``dtype`` (None: promoted with the fp32 parameters)."""

    def __init__(self, dim: int, dtype: Optional[torch.dtype] = None,
                 eps: float = 1e-6):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = _compute_dtype(self.dtype, x, self.weight)
        y = F.layer_norm(x.float(), self.weight.shape, self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(out)


class PatchifyConv(nn.Module):
    """Stride-p VALID patch embedding as im2col + matmul.

    The weight is (D, p·p·C) with the flattened taps in (row, col, channel)
    order, the JAX kernel (p, p, C, D) reshaped and transposed. A matmul and
    not a convolution keeps fp32 off cuDNN's TF32 default.
    """

    def __init__(self, in_chans: int, features: int, patch_size: int, *,
                 bias: bool = True, dtype: Optional[torch.dtype] = None,
                 generator: torch.Generator):
        super().__init__()
        self.patch_size = patch_size
        self.dtype = dtype
        fan_in = patch_size * patch_size * in_chans
        self.weight = nn.Parameter(init_weight(
            (features, fan_in), "lecun_normal", generator, fan_in=fan_in))
        self.bias = nn.Parameter(torch.zeros(features)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (N, H, W, C) → (N, H//p, W//p, D), tail-cropped like a conv."""
        N, H, W, C = x.shape
        p = self.patch_size
        hh, ww = H // p, W // p
        dt = _compute_dtype(self.dtype, x, self.weight)
        x = x[:, :hh * p, :ww * p].to(dt)
        cols = x.reshape(N, hh, p, ww, p, C).permute(0, 1, 3, 2, 4, 5)
        cols = cols.reshape(N, hh * ww, p * p * C)
        out = cols @ self.weight.to(dt).t()
        if self.bias is not None:
            out = out + self.bias.to(out.dtype)
        return out.reshape(N, hh, ww, -1)


class FusedMHA(nn.Module):
    """Multi-head self-attention with a fused qkv projection over axis 1 of
    a (B, S, T, D) input, batched over (B, T): the JAX ``FusedMHA``
    ``seq_axis=1`` einsum path. Scores and softmax stay in the compute
    dtype, as there; the products are plain matmuls."""

    def __init__(self, dim: int, num_heads: int, *,
                 dtype: Optional[torch.dtype] = None,
                 generator: torch.Generator):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Dense(dim, 3 * dim, dtype=dtype, init="xavier_uniform",
                         generator=generator)
        self.out = Dense(dim, dim, dtype=dtype, init="xavier_uniform",
                         generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, S, T, D = x.shape
        H = self.num_heads
        dh = D // H
        qkv = self.qkv(x)

        def heads(t):                                   # → (B, T, H, S, dh)
            return t.reshape(B, S, T, H, dh).permute(0, 2, 3, 1, 4)

        q, k, v = (heads(t) for t in qkv.chunk(3, dim=-1))
        scores = (q @ k.transpose(-1, -2)) * (1.0 / math.sqrt(dh))
        w = torch.softmax(scores, dim=-1).to(v.dtype)
        out = (w @ v).permute(0, 3, 1, 2, 4).reshape(B, S, T, D)
        return self.out(out)
