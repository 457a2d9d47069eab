"""Whole-row multi-head attention for short token rows: kernels K9 and K10.

Counterpart of the JAX package's ``ops/vision_attention.py``: ``vision_mha``
(the Pallas kernel ``_mha_kernel``) on (I, H, N, dh) and ``row_mha_qkv``
(``_row_mha_kernel``) on a head-major packed (B, T, 3H, N, dh) qkv, each
with its ``custom_vjp``. Both compute softmax attention with fp32 scores
over whole rows of at most ``MAX_ROW_TOKENS`` tokens; they differ where
they scale: K9 multiplies q by ``sm_scale`` in q's dtype before the
product, K10 multiplies the fp32 scores. Both take the max and the sum in
fp32 over the row, cast the weights to v's dtype before ``w @ v``, sum
that product in fp32 and cast the output to the input dtype. In bf16 those
places show, so the plain versions ``vision_mha_ref`` and
``row_mha_qkv_ref`` keep them.

``csrc/row_mha_fwd.cu`` holds both kernels (entries ``vision_mha_fwd`` and
``row_mha_fwd``). The C entries pick the kernel by dtype: bf16 runs on
the tensor cores (bf16 ``mma.sync`` tiles with fp32 sums,
``csrc/attention_mma.cuh``), K9 in ``vision_mha_mma_kernel`` and K10 in
``row_mha_mma_kernel``; fp32 (K9 and K10) runs the SIMT kernel
``row_mha_kernel``, because the TPU kernels' fp32 products are full fp32,
which TF32 tensor cores would not hold to the fp32 tolerances. Both take
any head width, as the JAX functions do: up to 128 zero-filled in shared
memory, above that in 128-column slices whose score products are summed
(each block then writes one slice of the output). Both read
q, k and v through strides: any view whose
last dimension is contiguous, so ``FusedMHA`` hands K10 the projection's
own (B, S, T, 3D) output and takes the output in (B, S, T, D) without a
copy either way. ``vision_mha_fwd`` and ``row_mha_fwd`` launch them on
CUDA tensors and raise on anything they do not take. ``vision_mha`` and
``row_mha_qkv`` are autograd Functions: the kernel forward on CUDA, the
plain version on the CPU, and the JAX package's einsum-form backward with
the scores recomputed (plain torch on both: the JAX backward is no Pallas
kernel either).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ._build import entry, launch, ptr

SOURCE = "row_mha_fwd"
ROW_KERNEL = "row_mha_fwd"          # K10
VISION_KERNEL = "vision_mha_fwd"    # K9
MAX_ROW_TOKENS = 512
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
              ctypes.c_int, ctypes.c_int, ctypes.c_float]
             + [ctypes.c_longlong] * 16 + [ctypes.c_void_p] * 4)


def _scale(sm_scale: Optional[float], dh: int) -> float:
    return 1.0 / math.sqrt(dh) if sm_scale is None else float(sm_scale)


def _softmax_wv(s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The kernels' softmax and product: exact fp32 max and sum over the
    row, the weights cast to v's dtype, ``w @ v`` summed in fp32."""
    s = s - s.amax(dim=-1, keepdim=True)
    e = torch.exp(s)
    w = (e / e.sum(dim=-1, keepdim=True)).to(v.dtype)
    return w.float() @ v.float()


def vision_mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   sm_scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of K9 on (I, H, N, dh): q times ``sm_scale`` (default
    1/sqrt(dh)) rounded to q's dtype, then fp32 scores."""
    scale = _scale(sm_scale, q.shape[-1])
    qm = q * torch.tensor(scale, dtype=q.dtype, device=q.device)
    s = qm.float() @ k.float().transpose(-1, -2)
    return _softmax_wv(s, v).to(q.dtype)


def _split_heads(qkv5: torch.Tensor):
    h = qkv5.shape[2] // 3
    return qkv5[:, :, :h], qkv5[:, :, h:2 * h], qkv5[:, :, 2 * h:]


def row_mha_qkv_ref(qkv5: torch.Tensor,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of K10 on head-major (B, T, 3H, N, dh) → (B, T, H,
    N, dh): fp32 scores times ``sm_scale`` (default 1/sqrt(dh))."""
    q, k, v = _split_heads(qkv5)
    scale = _scale(sm_scale, qkv5.shape[-1])
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    return _softmax_wv(s, v).to(qkv5.dtype)


def _empty_in_order(like: torch.Tensor, shape) -> torch.Tensor:
    """An empty tensor of ``shape`` (like's rank) whose leading dimensions
    lie in memory in the order of like's strides (the last dimension
    contiguous), so that the output of a strided view keeps its layout."""
    lead = len(shape) - 1
    order = sorted(range(lead), key=lambda d: -like.stride(d))
    buf = torch.empty([shape[d] for d in order] + [shape[-1]],
                      dtype=like.dtype, device=like.device)
    inverse = sorted(range(lead), key=lambda d: order[d])
    return buf.permute(*inverse, lead)


def _launch(name: str, q, k, v, out, scale: float) -> None:
    """Launch K9 or K10 on 5-D (outer0, outer1, H, N, dh) views."""
    tensors = {"q": q, "k": k, "v": v, "out": out}
    for label, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name} launches a CUDA kernel; {label} is on "
                             f"{t.device}")
        if t.device != q.device:
            raise ValueError(f"{name}: {label} is on {t.device}, q on "
                             f"{q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: {label} is {t.dtype}, q {q.dtype}")
        if t.shape != q.shape:
            raise ValueError(f"{name}: {label} has shape {tuple(t.shape)}, "
                             f"q {tuple(q.shape)}")
        if t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"{name}: the last dimension of {label} must "
                             "be contiguous")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name} takes float32 or bfloat16, got {q.dtype}")
    o0, o1, heads, n, dh = q.shape
    if n > MAX_ROW_TOKENS:
        raise ValueError(f"{name}: N={n} exceeds the whole-row limit "
                         f"{MAX_ROW_TOKENS}")
    if dh < 1:
        raise ValueError(f"{name}: head width {dh} is empty")
    if q.numel() == 0:
        return
    strides = [s for t in (q, k, v, out) for s in t.stride()[:4]]
    lib = entry(SOURCE, name, _ARGTYPES)
    launch(name, lib, q.device, _DTYPE_CODES[q.dtype], o0, o1, heads, n, dh,
           scale, *strides, *(ptr(t) for t in (q, k, v, out)))


def vision_mha_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   sm_scale: Optional[float] = None) -> torch.Tensor:
    """Launch K9 on CUDA tensors (I, H, N, dh), float32 or bfloat16, N <=
    512, any dh, any strides with the last dimension contiguous; the
    output keeps q's layout. bfloat16 runs on the tensor cores
    (``vision_mha_mma_kernel``), float32 on the SIMT kernel
    (``row_mha_kernel``) to keep full fp32 products. Raises on anything
    else."""
    if q.dim() != 4:
        raise ValueError(f"q must be (I, H, N, dh), got {tuple(q.shape)}")
    scale = _scale(sm_scale, q.shape[-1])
    if q.dtype in _DTYPE_CODES:      # the scale as the TPU kernel holds it
        scale = torch.tensor(scale, dtype=q.dtype).item()
    out = _empty_in_order(q, q.shape)
    _launch(VISION_KERNEL, q[:, None], k[:, None], v[:, None], out[:, None],
            scale)
    return out


def row_mha_fwd(qkv5: torch.Tensor,
                sm_scale: Optional[float] = None) -> torch.Tensor:
    """Launch K10 on a CUDA (B, T, 3H, N, dh) qkv, float32 or bfloat16,
    N <= 512, any dh, any strides with the last dimension contiguous:
    returns (B, T, H, N, dh), laid out in memory as qkv5 is. bfloat16 runs
    on the tensor cores (``row_mha_mma_kernel``), float32 on the SIMT
    kernel (``row_mha_kernel``) to keep full fp32 products. Raises on
    anything else."""
    if qkv5.dim() != 5 or qkv5.shape[2] % 3:
        raise ValueError(f"qkv5 must be (B, T, 3H, N, dh), got "
                         f"{tuple(qkv5.shape)}")
    q, k, v = _split_heads(qkv5)
    out = _empty_in_order(qkv5, q.shape)
    _launch(ROW_KERNEL, q, k, v, out, _scale(sm_scale, qkv5.shape[-1]))
    return out


def _mha_bwd(q, k, v, g, scale: float):
    """The JAX package's einsum-form backward (``_mha_bwd``,
    ``_row_mha_bwd``) over any leading dimensions: fp32 scores recomputed,
    their softmax in fp32."""
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    w = torch.softmax(s, dim=-1)
    dv = w.to(g.dtype).transpose(-1, -2) @ g
    dp = g.float() @ v.float().transpose(-1, -2)
    ds = w * (dp - (dp * w).sum(dim=-1, keepdim=True))
    ds = (ds * scale).to(q.dtype)
    return ds @ k, ds.transpose(-1, -2) @ q, dv


class VisionMHA(torch.autograd.Function):
    """K9 forward on CUDA (its plain version on the CPU), the einsum-form
    backward: the JAX ``_mha`` with its ``custom_vjp``."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale):
        fwd = vision_mha_fwd if q.device.type == "cuda" else vision_mha_ref
        ctx.sm_scale = sm_scale
        ctx.save_for_backward(q, k, v)
        return fwd(q, k, v, sm_scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        return (*_mha_bwd(q, k, v, g, ctx.sm_scale), None)


class RowMHA(torch.autograd.Function):
    """K10 forward on CUDA (its plain version on the CPU), the einsum-form
    backward repacked into the 3H layout: the JAX ``_row_mha`` with its
    ``custom_vjp``."""

    @staticmethod
    def forward(ctx, qkv5, sm_scale):
        fwd = row_mha_fwd if qkv5.device.type == "cuda" else row_mha_qkv_ref
        ctx.sm_scale = sm_scale
        ctx.save_for_backward(qkv5)
        return fwd(qkv5, sm_scale)

    @staticmethod
    def backward(ctx, g):
        (qkv5,) = ctx.saved_tensors
        grads = _mha_bwd(*_split_heads(qkv5), g, ctx.sm_scale)
        return torch.cat(grads, dim=2), None


def vision_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               sm_scale: Optional[float] = None) -> torch.Tensor:
    """Whole-row MHA, q/k/v (I, H, N, dh) → (I, H, N, dh); N <=
    ``MAX_ROW_TOKENS``; ``sm_scale`` defaults to 1/sqrt(dh). K9 on CUDA
    tensors, the plain version on the CPU; differentiable."""
    I, H, n, dh = q.shape
    if n > MAX_ROW_TOKENS:
        raise ValueError(f"vision_mha: N={n} exceeds whole-row limit "
                         f"{MAX_ROW_TOKENS}; use the flash kernel instead")
    return VisionMHA.apply(q, k, v, _scale(sm_scale, dh))


def row_mha_qkv(qkv5: torch.Tensor,
                sm_scale: Optional[float] = None) -> torch.Tensor:
    """Head-major packed-qkv whole-row MHA: qkv5 (B, T, 3H, N, dh), q heads
    at [:H], k at [H:2H], v at [2H:] → (B, T, H, N, dh); N <=
    ``MAX_ROW_TOKENS``. K10 on CUDA tensors, the plain version on the CPU;
    differentiable."""
    b, t, h3, n, dh = qkv5.shape
    if h3 % 3:
        raise ValueError(f"row_mha_qkv: 3H dim {h3} not divisible by 3")
    if n > MAX_ROW_TOKENS:
        raise ValueError(f"row_mha_qkv: N={n} exceeds whole-row limit "
                         f"{MAX_ROW_TOKENS}")
    return RowMHA.apply(qkv5, _scale(sm_scale, dh))
