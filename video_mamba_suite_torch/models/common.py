"""Building blocks of the towers, the LM and the task heads (counterparts
of the JAX package's ``models/common.py``: ``make_dense``,
``PatchifyConv``, ``FusedMHA``, ``W8Embed``, ``sinusoid_positions``, the
masked 1-D blocks ``AffineDropPath``, ``MaskedConv1D``, ``LayerNorm1D``,
``max_pool_1d`` and ``MaskMambaBlock``, the segmentation heads' masked
``instance_norm_1d`` and ``sliding_window_attention``, and flax's
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

from ..ops.flash_attention import flash_mha
from ..ops.norms import layer_norm
from ..ops.vision_attention import MAX_ROW_TOKENS, row_mha_qkv, vision_mha


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
    "he_fan_out" (flax variance_scaling(2, fan_out, truncated_normal), the
    masked convs' init), "xavier_uniform", or "torch_linear" (torch
    nn.Linear's U(±1/√fan_in))."""
    w = torch.empty(shape, dtype=torch.float32)
    if kind in ("lecun_normal", "he_fan_out"):
        # flax variance_scaling(scale, fan, truncated_normal): the std of a
        # normal truncated at ±2σ is 0.8796σ, so σ is scaled up by that
        var = 1.0 / fan_in if kind == "lecun_normal" else 2.0 / fan_out
        std = math.sqrt(var) / 0.87962566103423978
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


def _absmax_int8(w: torch.Tensor, dim: int):
    """Symmetric absmax int8 along ``dim`` (the reduced axis): (int8
    tensor, fp32 scales) with the scales floored at 1e-8; the rounding is
    half to even, as ``jnp.round``."""
    w = w.detach().float()
    scale = (w.abs().amax(dim=dim) / 127.0).clamp_min(1e-8)
    return torch.round(w / scale.unsqueeze(dim)).to(torch.int8), scale


def bf16_matmul_fp32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., in) @ w (out, in)^T with both rounded to bf16 and the
    product accumulated and returned in fp32 (``jnp.dot`` of bf16 inputs
    with ``preferred_element_type=float32``): no rounding to bf16 before
    a scale is applied. cuBLAS writes the fp32 result on the card; on the
    CPU the bf16 values are widened to fp32, whose products are exact."""
    x = x.to(torch.bfloat16)
    w = w.to(torch.bfloat16)
    if x.is_cuda:
        out = torch.mm(x.reshape(-1, x.shape[-1]), w.t(),
                       out_dtype=torch.float32)
        return out.reshape(*x.shape[:-1], w.shape[0])
    return F.linear(x.float(), w.float())


class _Int8Weight:
    """Offline int8 storage of a module's 2-D ``weight``: ``quantize_``
    replaces it by int8 with a fp32 scale per row (dim 0) in the buffer
    ``qscale``, None until then."""

    def _init_int8(self) -> None:
        self.register_buffer("qscale", None)

    def quantize_(self) -> None:
        """Quantize ``weight`` in place, one scale per row."""
        q, scale = _absmax_int8(self.weight, dim=1)
        self.weight = nn.Parameter(q, requires_grad=False)
        self.qscale = scale


class W8Dense(_Int8Weight, Dense):
    """``Dense`` that can hold offline-quantized int8 weights (the JAX
    ``W8Dense``). Until ``quantize_`` it is exactly ``Dense``. After it,
    ``weight`` is int8 (out, in) with a fp32 scale per output channel in
    ``qscale``, and the forward is bf16(x) @ bf16(int8 weight) in fp32,
    times the scale, plus the bias, in the compute dtype (x's without
    one). Inference only: the int8 weight takes no gradient."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._init_int8()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.qscale is None:
            return super().forward(x)
        y = bf16_matmul_fp32(x, self.weight) * self.qscale
        if self.bias is not None:
            y = y + self.bias
        return y.to(self.dtype or x.dtype)


class W8Embed(_Int8Weight, Embedding):
    """``Embedding`` that can hold an offline-quantized int8 table (the
    JAX ``W8Embed``). Until ``quantize_`` it is exactly ``Embedding``.
    After it, ``weight`` is int8 with a fp32 scale per row in ``qscale``,
    and a lookup returns bf16(rows) * bf16(their scales), in bf16."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._init_int8()

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        if self.qscale is None:
            return super().forward(ids)
        rows = self.weight[ids].to(torch.bfloat16)
        return rows * self.qscale[ids].to(torch.bfloat16)[..., None]


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
    """Multi-head self-attention with a fused qkv projection: the JAX
    ``FusedMHA``. Attention runs over axis ``seq_axis`` of the input: -2 on
    any (..., L, D) input, or 1 on a (B, S, T, D) input, batched over
    (B, T) without a transpose of the input. Scores and softmax stay in the
    compute dtype, as there; the products are plain matmuls, and
    ``causal`` masks the scores at -1e30 in their dtype (axis -2 only).

    ``flash`` picks a kernel under the JAX package's conditions, in its
    order:
      - "row": on the 4-D ``seq_axis=1`` path, not causal, S <= 512: the
        whole-row kernel K10 (``ops.vision_attention.row_mha_qkv``), which
        reads q, k and v from the projection's (B, S, T, 3D) output through
        strides and writes (B, S, T, D) for the output projection (the JAX
        package's head-major projections ``_HeadMajorQKV`` /
        ``_HeadMajorOut`` computed through views: the same ``qkv`` and
        ``out`` parameters, so one state dict serves every ``flash``).
        Above 512 tokens it takes the einsum path.
      - "vmem": on a 3-D (B, L, D) input, not causal, L <= 512: the
        whole-row kernel K9 (``ops.vision_attention.vision_mha``).
      - True: on a CUDA 3-D (B, L, D) input with dh a multiple of 64,
        causal or not: the flash kernel K11 (``ops.flash_attention.
        flash_mha``: its forward and, in a backward, its backward kernel),
        which reads q, k and v from the projection's output through
        strides; on the CPU, as the JAX package off the TPU, the einsum
        path.
    On the ``seq_axis=1`` path anything but None or "row", and ``causal``,
    raise ValueError, as in the JAX package. Off the CPU each kernel path
    launches its kernel or raises; none falls back."""

    def __init__(self, dim: int, num_heads: int, *,
                 dtype: Optional[torch.dtype] = None, causal: bool = False,
                 flash=None, seq_axis: int = -2,
                 generator: torch.Generator):
        super().__init__()
        self.num_heads = num_heads
        self.causal = causal
        self.flash = flash
        self.seq_axis = seq_axis
        self.qkv = Dense(dim, 3 * dim, dtype=dtype, init="xavier_uniform",
                         generator=generator)
        self.out = Dense(dim, dim, dtype=dtype, init="xavier_uniform",
                         generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        D = x.shape[-1]
        H = self.num_heads
        dh = D // H
        four_d = self.seq_axis == 1 and x.dim() == 4
        if (self.flash == "row" and four_d and not self.causal
                and x.shape[1] <= MAX_ROW_TOKENS):
            B, S, T = x.shape[:3]
            # (B, S, T, 3D) viewed head-major as (B, T, 3H, S, dh); the
            # output (B, T, H, S, dh) lies in memory as (B, S, T, H, dh)
            qkv5 = self.qkv(x).view(B, S, T, 3 * H, dh).permute(0, 2, 3, 1, 4)
            out5 = row_mha_qkv(qkv5)
            return self.out(out5.permute(0, 3, 1, 2, 4).reshape(B, S, T, D))
        q, k, v = self.qkv(x).chunk(3, dim=-1)
        if four_d:
            if self.causal or (self.flash and self.flash != "row"):
                raise ValueError("seq_axis=1 supports plain bidirectional "
                                 "attention only")
            B, S, T = x.shape[:3]

            def heads4(t):                              # → (B, T, H, S, dh)
                return t.reshape(B, S, T, H, dh).permute(0, 2, 3, 1, 4)

            q, k, v = heads4(q), heads4(k), heads4(v)
            scores = (q @ k.transpose(-1, -2)) * (1.0 / math.sqrt(dh))
            w = torch.softmax(scores, dim=-1).to(v.dtype)
            out = (w @ v).permute(0, 3, 1, 2, 4).reshape(B, S, T, D)
            return self.out(out)

        def heads(t):                                   # → (..., H, L, dh)
            return t.reshape(t.shape[:-1] + (H, dh)).transpose(-2, -3)

        q, k, v = heads(q), heads(k), heads(v)
        L = x.shape[-2]
        if (self.flash == "vmem" and x.dim() == 3 and not self.causal
                and L <= MAX_ROW_TOKENS):
            out = vision_mha(q, k, v)                   # (B, H, L, dh)
            return self.out(out.transpose(1, 2).reshape(x.shape[:-1] + (D,)))
        if (self.flash is True and x.is_cuda and x.dim() == 3
                and dh % 64 == 0):
            # (B, H, L, dh) views back to the projection's (B, L, H, dh)
            out = flash_mha(*(t.transpose(1, 2) for t in (q, k, v)),
                            self.causal)
            return self.out(out)
        scores = (q @ k.transpose(-1, -2)) * (1.0 / math.sqrt(dh))
        if self.causal:
            keep = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
            scores = scores.masked_fill(~keep, -1e30)
        w = torch.softmax(scores, dim=-1).to(v.dtype)
        out = (w @ v).transpose(-2, -3)                 # (..., L, H, dh)
        return self.out(out.reshape(out.shape[:-2] + (D,)))


class AffineDropPath(nn.Module):
    """Drop-path with a learnable per-channel ``scale`` (1, 1, dim),
    initialised to 1e-4 (the JAX ``AffineDropPath``): drop_path(x ·
    scale), the mask drawn from the caller's generator."""

    def __init__(self, dim: int, rate: float = 0.0):
        super().__init__()
        self.rate = rate
        self.scale = nn.Parameter(torch.full((1, 1, dim), 1e-4))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return drop_path(x * self.scale, self.rate, self.training, generator)


class MaskedConv1D(nn.Module):
    """1-D convolution over time with the mask applied before and after
    (the JAX ``MaskedConv1D``). x (B, L, C) and mask (B, L) → (out (B,
    L_out, features), out_mask), with out_mask = mask[:, ::stride]. The
    input is padded (k-1)//2 steps on the left and the rest on the right,
    as flax pads it. ``weight`` is (features, C, k), torch's layout
    (the flax kernel (k, C, features) transposed); ``bias`` (features,) or
    None. Initial weights: flax variance_scaling(2, fan_out,
    truncated_normal); the bias zero."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: int = 3, stride: int = 1,
                 use_bias: bool = True, *,
                 generator: torch.Generator, init: str = "he_fan_out"):
        super().__init__()
        self.kernel_size, self.stride = kernel_size, stride
        self.weight = nn.Parameter(init_weight(
            (features, in_features, kernel_size), init, generator,
            fan_in=kernel_size * in_features,
            fan_out=kernel_size * features))
        self.bias = (nn.Parameter(torch.zeros(features)) if use_bias
                     else None)

    def conv(self, x: torch.Tensor) -> torch.Tensor:
        """The convolution alone, (B, L, C) → (B, L_out, features)."""
        span = self.kernel_size - 1
        x = F.pad(x.transpose(1, 2), (span // 2, span - span // 2))
        out = F.conv1d(x, self.weight.to(x.dtype),
                       None if self.bias is None else self.bias.to(x.dtype),
                       stride=self.stride)
        return out.transpose(1, 2)

    def forward(self, x: torch.Tensor, mask: torch.Tensor):
        out = self.conv(x * mask.to(x.dtype)[..., None])
        out_mask = mask[:, ::self.stride] if self.stride > 1 else mask
        return out * out_mask.to(out.dtype)[..., None], out_mask


class LayerNorm1D(nn.Module):
    """LayerNorm over the channels with ``norm_w`` and ``norm_b``, eps
    1e-5, computed in fp32 and cast back to the input's dtype (the JAX
    ``LayerNorm1D``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm_w = nn.Parameter(torch.ones(dim))
        self.norm_b = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.norm_w, self.norm_b, eps=1e-5)


def instance_norm_1d(x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                     eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm1d without affine on (B, L, C): each channel of each
    sample normalised over time, in fp32, cast back to x's dtype (the JAX
    ``instance_norm_1d``). With ``mask`` (B, L) the statistics take the
    valid steps only, so a padded batch gives what the unpadded one gives
    (upstream's norm takes the padding too; the JAX package is the spec
    here)."""
    xf = x.float()
    if mask is None:
        mean = xf.mean(dim=1, keepdim=True)
        var = xf.var(dim=1, unbiased=False, keepdim=True)
    else:
        m = mask.float()[..., None]
        cnt = m.sum(dim=1, keepdim=True).clamp_min(1.0)
        mean = (xf * m).sum(dim=1, keepdim=True) / cnt
        var = ((xf - mean).square() * m).sum(dim=1, keepdim=True) / cnt
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def _log_mask(mask: torch.Tensor) -> torch.Tensor:
    """log(mask + 1e-6): a masked key's score drops by about 13.8, not to
    -inf, so a window whose keys are all masked gets uniform weights
    (multiplied by 0 after the softmax) and no NaN."""
    return torch.log(mask.float() + 1e-6)


def sliding_window_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, mask: torch.Tensor, bl: int
                             ) -> torch.Tensor:
    """ASFormer's sliding-window attention, all blocks at once (the JAX
    ``sliding_window_attention``): q, k (B, L, dq), v (B, L, dv), mask
    (B, L) → (B, L, dv). Query block i (``bl`` steps) attends to the
    keys of the window [i·bl − bl//2, (i+1)·bl + bl//2), query row r of
    the block to window columns [r, r + bl), masked keys through
    ``_log_mask``; the softmax weights are multiplied by the window's mask
    and the output by the query mask. Scores and softmax in the inputs'
    dtype (fp32 in the suite) through plain matmuls."""
    B, L, dq = q.shape
    dv = v.shape[-1]
    nb = -(-L // bl)
    half = bl // 2
    win = bl + 2 * half
    # keys padded by `half` on the left and to (nb + 1)·bl in all, so the
    # window of block i lies inside blocks i and i + 1
    right = (nb + 1) * bl - L - half
    qb = F.pad(q, (0, 0, 0, nb * bl - L)).reshape(B, nb, bl, dq)

    def windows(t):
        """(B, L, c) → (B, nb, win, c)."""
        blocks = F.pad(t, (0, 0, half, right)).reshape(B, nb + 1, bl, -1)
        return torch.cat([blocks[:, :nb], blocks[:, 1:]], dim=2)[:, :, :win]

    kb, vb = windows(k), windows(v)
    mb = windows(mask.float()[..., None])[..., 0]              # (B, nb, win)
    rows = torch.arange(bl, device=q.device)[:, None]
    cols = torch.arange(win, device=q.device)[None]
    wmask = ((cols >= rows) & (cols < rows + bl)).float()      # (bl, win)
    scores = (qb @ kb.transpose(-1, -2)) / math.sqrt(dq)
    full_mask = wmask[None, None] * mb[:, :, None, :]
    scores = scores + _log_mask(full_mask)
    attn = torch.softmax(scores, dim=-1) * full_mask
    out = (attn @ vb).reshape(B, nb * bl, dv)[:, :L]
    return out * mask.to(out.dtype)[..., None]


def max_pool_1d(x: torch.Tensor, mask: torch.Tensor, kernel: int = 3,
                stride: int = 2, padding: int = 1):
    """Max over windows of ``kernel`` steps every ``stride``, the input
    padded with -inf by ``padding`` on each side; the mask downsampled by
    taking every ``stride``-th step, cut to the output's length, and
    applied (the JAX ``max_pool_1d``). x (B, L, C), mask (B, L)."""
    out = F.max_pool1d(x.transpose(1, 2), kernel, stride,
                       padding).transpose(1, 2)
    out_mask = mask[:, ::stride][:, :out.shape[1]]
    return out * out_mask.to(out.dtype)[..., None], out_mask


class MaskMambaBlock(nn.Module):
    """norm → Mamba mixer → mask → residual through ``AffineDropPath``,
    then an optional max-pool (the JAX ``MaskMambaBlock``). ``mixer`` is
    "vim" (``MambaVim``, expand 2) or "dbm" (``MambaDBM``, expand 1), with
    conv width ``kernel_size``. At ``drop_path_rate`` 0 the block has no
    ``AffineDropPath`` and no scale, as in the JAX tree. Runs on the
    device it is built on; ``device="cpu"`` for the plain versions."""

    def __init__(self, dim: int, mixer: str = "vim", kernel_size: int = 4,
                 n_ds_stride: int = 1, drop_path_rate: float = 0.3, *,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        from .mamba import MambaDBM, MambaVim   # .mamba imports this module

        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.n_ds_stride = n_ds_stride
        self.norm = LayerNorm1D(dim)
        if mixer == "vim":
            self.mamba = MambaVim(dim, d_conv=kernel_size, device="cpu",
                                  generator=generator)
        elif mixer == "dbm":
            self.mamba = MambaDBM(dim, d_conv=kernel_size, expand=1,
                                  device="cpu", generator=generator)
        else:
            raise ValueError(f"unknown mixer {mixer!r}; expected 'vim' or "
                             "'dbm'")
        self.drop_path = (AffineDropPath(dim, drop_path_rate)
                          if drop_path_rate > 0 else None)
        self.to(device)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        """x (B, L, dim), mask (B, L) → (x, mask), both pooled with
        ``n_ds_stride`` > 1. ``generator`` (on x's device) draws the
        drop-path masks in training mode."""
        h = self.mamba(self.norm(x), mask)
        h = h * mask.to(h.dtype)[..., None]
        if self.drop_path is not None:
            h = self.drop_path(h, generator)
        x = x + h
        if self.n_ds_stride > 1:
            x, mask = max_pool_1d(x, mask, 3, self.n_ds_stride, 1)
        return x, mask
