"""Flash attention with an online softmax, forward and backward: kernel K11.

Counterpart of the JAX package's ``_flash_mha`` (``models/common.py``),
which runs jax's Pallas TPU ``flash_attention`` (forward
``_flash_attention_kernel``, backward ``_flash_attention_dkv_kernel`` and
``_flash_attention_dq_kernel``) on (B, L, H, dh) heads, causal or not, and
returns (B, L, H·dh). Per (batch, head) and query row i:

    s_ij = (q_i . k_j) * scale       products of the I/O type, fp32 sums,
                                     scale = 1/sqrt(dh) after the product
    p_ij = softmax_j(s_ij)           fp32; causal keeps key j <= i
    o_i  = sum_j round(p_ij) v_j     the weights rounded to v's type,
                                     fp32 sums, the output in q's type

and the backward from the per-row log-sum-exp ``lse`` that the forward
keeps: di = sum(o * do) in fp32, dv = p^T do, ds = p (dp - di) scale with
dp = do v^T, dq = ds k and dk = ds^T q, where p and ds are rounded to the
I/O type before their products (the library's casts). ``_flash_mha`` pads L
to a multiple of 128 and masks the pad keys with segment ids; that is
layout only, so here keys at or past L are masked and nothing is padded.

``csrc/flash_mha.cu`` holds both kernels, one C entry each: the forward
``flash_mha_fwd`` and the backward ``flash_mha_bwd`` (a di pass, then dk and
dv per key tile, then dq per query tile). Both pick their kernels by
dtype: bf16 runs on the tensor cores (bf16 ``mma.sync`` tiles with fp32
sums, ``csrc/attention_mma.cuh``: ``flash_mha_fwd_mma_kernel``, and
``flash_mha_bwd_dkdv_mma_kernel`` and ``flash_mha_bwd_dq_mma_kernel``
after the shared di kernel), fp32 on the SIMT kernels
(``flash_mha_fwd_kernel``, ``flash_mha_bwd_dkdv_kernel``,
``flash_mha_bwd_dq_kernel``), because the library's fp32 products are
full fp32, which TF32 tensor cores would not hold to the fp32
tolerances. Both read q, k and v through strides: any (B, L, H, dh) view
whose last dimension is contiguous, so ``FusedMHA`` hands them the
projection's own (B, L, 3D) output without a copy. They take the head
widths that jax's ``flash_attention`` computes (``takes_head_width``): up
to 128, zero-filled in shared memory to the kernels' 64 or 128 columns,
and multiples of 128, in 128-column slices whose score products are
summed (each block then writes one slice of each output). A width that is
no multiple of 8 is given to the kernels as one contiguous copy
zero-padded to the next multiple of 8 (zero columns change neither the
scores nor the kept columns of the outputs). The wrappers
``flash_mha_fwd`` and ``flash_mha_bwd`` launch them on CUDA tensors and
raise on anything they do not take; ``flash_mha_ref`` and
``flash_mha_bwd_ref`` are the plain versions. ``flash_mha`` is the autograd
Function ``FlashMHA``: the kernels on CUDA, the plain versions on the CPU.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from ._build import entry, launch, ptr

SOURCE = "flash_mha"              # csrc/flash_mha.cu, both entries
FWD_KERNEL = "flash_mha_fwd"
BWD_KERNEL = "flash_mha_bwd"
COLUMN_SLICE = 128                # head widths above this run in slices
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_FWD_ARGTYPES = ([ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                  ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float]
                 + [ctypes.c_longlong] * 9 + [ctypes.c_void_p] * 5)
_BWD_ARGTYPES = _FWD_ARGTYPES + [ctypes.c_void_p] * 5


def takes_head_width(dh: int) -> bool:
    """The head widths K11 takes, those jax's Pallas ``flash_attention``
    computes: any up to 128, and multiples of 128 above that."""
    return dh > 0 and (dh <= COLUMN_SLICE or dh % COLUMN_SLICE == 0)


def _heads(t: torch.Tensor) -> torch.Tensor:
    """(B, L, H, dh) → (B, H, L, dh) as fp32."""
    return t.transpose(1, 2).float()


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool) -> torch.Tensor:
    """fp32 (B, H, L, L) scores times 1/sqrt(dh) (the library's sm_scale),
    -inf where masked."""
    s = (_heads(q) @ _heads(k).transpose(-1, -2)) * (
        1.0 / math.sqrt(q.shape[-1]))
    if causal:
        L = q.shape[1]
        keep = torch.ones(L, L, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    return s


def flash_mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K11's forward on (B, L, H, dh): returns the output
    (B, L, H·dh) in q's dtype and the fp32 log-sum-exp (B, H, L) of each
    query row's scaled scores."""
    B, L, H, dh = q.shape
    s = _scores(q, k, causal)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(dim=-1, keepdim=True)
    w = (e / l).to(v.dtype).float()
    out = (w @ _heads(v)).to(q.dtype).transpose(1, 2).reshape(B, L, H * dh)
    return out, (m + torch.log(l)).squeeze(-1)


def flash_mha_bwd_ref(q, k, v, out, lse, dout, causal: bool = False):
    """Plain version of K11's backward: (dq, dk, dv), each (B, L, H, dh) in
    its input's dtype, from the forward's output (B, L, H·dh), its
    log-sum-exp (B, H, L) and the output's cotangent (B, L, H·dh)."""
    B, L, H, dh = q.shape
    scale = 1.0 / math.sqrt(dh)
    p = torch.exp(_scores(q, k, causal) - lse[..., None])
    do = dout.reshape(B, L, H, dh)
    di = (_heads(out.reshape(B, L, H, dh)) * _heads(do)).sum(-1)
    dv = p.to(do.dtype).float().transpose(-1, -2) @ _heads(do)
    dp = _heads(do) @ _heads(v).transpose(-1, -2)
    ds = (p * (dp - di[..., None]) * scale).to(q.dtype).float()
    dq = ds @ _heads(k)
    dk = ds.transpose(-1, -2) @ _heads(q)
    return tuple(g.to(t.dtype).transpose(1, 2)
                 for g, t in ((dq, q), (dk, k), (dv, v)))


def _check(q, k, v, name: str):
    """Raise unless K11 takes these (B, L, H, dh) q, k and v (their
    layout is checked by ``_check_layout``)."""
    if q.dim() != 4:
        raise ValueError(f"{name}: q must be (B, L, H, dh), got "
                         f"{tuple(q.shape)}")
    for label, t in (("q", q), ("k", k), ("v", v)):
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
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name} takes float32 or bfloat16, got {q.dtype}")
    B, L, H, dh = q.shape
    if not takes_head_width(dh):
        raise ValueError(f"{name}: head width {dh} is not taken (at most "
                         f"{COLUMN_SLICE}, or a multiple of {COLUMN_SLICE}, "
                         "as jax's flash_attention)")
    if H > 65535 or B > 65535:
        raise ValueError(f"{name}: at most 65535 heads and batch rows")


def _check_layout(name: str, **tensors):
    """Raise unless the kernels can read each (B, L, H, dh) tensor: they
    read 4 elements at a time."""
    for label, t in tensors.items():
        if (t.stride(-1) != 1 or any(s % 4 for s in t.stride()[:3])
                or t.data_ptr() % 16):
            raise ValueError(f"{name}: {label} needs a contiguous last "
                             "dimension, strides in multiples of 4 "
                             "elements and a 16-byte aligned start")


def _pad_width(*ts):
    """(B, L, H, dh) tensors as the kernels take them: as they are when dh
    is a multiple of 8, else one contiguous copy each, zero-padded to the
    next multiple of 8."""
    dh = ts[0].shape[-1]
    if dh % 8 == 0:
        return ts
    return tuple(torch.nn.functional.pad(t, (0, -dh % 8)).contiguous()
                 for t in ts)


def _strides(*ts):
    return [s for t in ts for s in t.stride()[:3]]


def flash_mha_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K11's forward on CUDA (B, L, H, dh) q, k, v of one dtype
    (float32 or bfloat16), dh as ``takes_head_width``, any strides with
    the last dimension contiguous: returns (out (B, L, H·dh) in q's dtype,
    lse (B, H, L) fp32), as ``flash_mha_ref``. bfloat16 runs on the tensor
    cores (``flash_mha_fwd_mma_kernel``), float32 on the SIMT kernel
    (``flash_mha_fwd_kernel``) to keep full fp32 products. Raises on
    anything else."""
    _check(q, k, v, FWD_KERNEL)
    B, L, H, dh = q.shape
    scale = 1.0 / math.sqrt(dh)
    q, k, v = _pad_width(q, k, v)
    _check_layout(FWD_KERNEL, q=q, k=k, v=v)
    dp = q.shape[-1]
    out = torch.empty(B, L, H * dp, dtype=q.dtype, device=q.device)
    lse = torch.empty(B, H, L, dtype=torch.float32, device=q.device)
    if q.numel():
        lib = entry(SOURCE, FWD_KERNEL, _FWD_ARGTYPES)
        launch(FWD_KERNEL, lib, q.device, _DTYPE_CODES[q.dtype], B, L, H, dp,
               int(causal), scale, *_strides(q, k, v),
               *(ptr(t) for t in (q, k, v, out, lse)))
    if dp != dh:
        out = out.view(B, L, H, dp)[..., :dh].reshape(B, L, H * dh)
    return out, lse


def flash_mha_bwd(q, k, v, out, lse, dout, causal: bool = False):
    """Launch K11's backward on CUDA tensors: q, k, v as ``flash_mha_fwd``
    takes them, its ``out`` and ``lse``, and the output's cotangent
    ``dout`` (contiguous (B, L, H·dh) in q's dtype; out and dout 16-byte
    aligned). Returns (dq, dk, dv), contiguous (B, L, H, dh) in q's dtype,
    as ``flash_mha_bwd_ref``. bfloat16 runs on the tensor cores
    (``flash_mha_bwd_dkdv_mma_kernel``, ``flash_mha_bwd_dq_mma_kernel``),
    float32 on the SIMT kernels to keep full fp32 products. Raises on
    anything else."""
    _check(q, k, v, BWD_KERNEL)
    B, L, H, dh = q.shape
    for label, t, shape, dtype in (("out", out, (B, L, H * dh), q.dtype),
                                   ("dout", dout, (B, L, H * dh), q.dtype),
                                   ("lse", lse, (B, H, L), torch.float32)):
        if t.device != q.device:
            raise ValueError(f"{BWD_KERNEL}: {label} is on {t.device}, q on "
                             f"{q.device}")
        if t.dtype != dtype:
            raise TypeError(f"{BWD_KERNEL}: {label} must be {dtype}, got "
                            f"{t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{BWD_KERNEL}: {label} must have shape "
                             f"{shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{BWD_KERNEL}: {label} must be contiguous")
        if label != "lse" and t.data_ptr() % 16:   # read 16 bytes a lane
            raise ValueError(f"{BWD_KERNEL}: {label} needs a 16-byte "
                             "aligned start")
    scale = 1.0 / math.sqrt(dh)
    q, k, v, out, dout = _pad_width(
        q, k, v, *(t.view(B, L, H, dh) for t in (out, dout)))
    _check_layout(BWD_KERNEL, q=q, k=k, v=v)
    dp = q.shape[-1]
    dq, dk, dv = (torch.empty(B, L, H, dp, dtype=q.dtype, device=q.device)
                  for _ in range(3))
    if q.numel():
        di = torch.empty(B, H, L, dtype=torch.float32, device=q.device)
        lib = entry(SOURCE, BWD_KERNEL, _BWD_ARGTYPES)
        launch(BWD_KERNEL, lib, q.device, _DTYPE_CODES[q.dtype], B, L, H, dp,
               int(causal), scale, *_strides(q, k, v),
               *(ptr(t) for t in (q, k, v, out, lse, dout, di, dq, dk, dv)))
    if dp != dh:
        dq, dk, dv = (t[..., :dh].contiguous() for t in (dq, dk, dv))
    return dq, dk, dv


class FlashMHA(torch.autograd.Function):
    """K11: its forward and its backward kernel on CUDA tensors, the plain
    versions on the CPU (the JAX ``flash_attention`` with its
    ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        fwd = flash_mha_fwd if q.device.type == "cuda" else flash_mha_ref
        out, lse = fwd(q, k, v, causal)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        bwd = flash_mha_bwd if q.device.type == "cuda" else flash_mha_bwd_ref
        dq, dk, dv = bwd(q, k, v, out, lse, dout.contiguous(), ctx.causal)
        return dq, dk, dv, None


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = False) -> torch.Tensor:
    """Softmax attention on (B, L, H, dh) heads → (B, L, H·dh), scale
    1/sqrt(dh), causal or not: K11 on CUDA tensors, the plain version on
    the CPU; differentiable in q, k and v."""
    return FlashMHA.apply(q, k, v, causal)
