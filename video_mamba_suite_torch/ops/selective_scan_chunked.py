"""Chunked selective scan, forward (kernel K3).

Counterpart of the JAX package's ``_scan_fwd_impl`` and its Pallas kernels
``_fwd_kernel`` and ``_fwd_kernel_hs``
(``video_mamba_suite_tpu/ops/selective_scan_pallas.py``): one direction of
a selective scan at any length, causal or anti-causal (``reverse``), with
an initial state, the last state, and per-step B/C shared by all channels
or by groups of channels. One CUDA kernel (``csrc/chunked_scan_fwd.cu``)
computes it for every batch size.

``chunked_scan_fwd`` launches the kernel on CUDA tensors and raises on
anything it does not take. ``ops.selective_scan.selective_scan`` is the
front end: it takes the plain version for CPU tensors and this kernel, via
the autograd Function ``ChunkedScan``, for CUDA tensors. The backward
(kernel K4) is not ported yet, so a backward through ``ChunkedScan``
raises instead of leaving the inputs without gradients.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ._build import launch, library, ptr

KERNEL = "chunked_scan_fwd"
MAX_DSTATE = 16      # largest state size the kernel takes

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check(u, delta, A, B, C, D, z, delta_bias, initial_state):
    """Raise unless the kernel takes these arguments; return (batch,
    seqlen, dim, dstate, ngroups)."""
    if u.dim() != 3:
        raise ValueError(f"u must be (batch, seqlen, dim), got "
                         f"{tuple(u.shape)}")
    batch, seqlen, dim = u.shape
    if A.is_complex() or B.is_complex() or C.is_complex():
        raise TypeError("complex A, B or C is not supported by the chunked "
                        "scan (the complex scan is another kernel)")
    if A.dim() != 2 or A.shape[0] != dim:
        raise ValueError(f"A must be (dim, dstate), got {tuple(A.shape)}")
    dstate = A.shape[1]
    if dstate > MAX_DSTATE:
        raise ValueError(f"dstate {dstate} > {MAX_DSTATE} is not supported")
    if B.dim() not in (3, 4) or B.shape != C.shape:
        raise ValueError("B and C must both be (batch, seqlen, dstate) or "
                         "(batch, seqlen, ngroups, dstate), got "
                         f"{tuple(B.shape)} and {tuple(C.shape)}")
    ngroups = B.shape[2] if B.dim() == 4 else 1
    if dim % ngroups:
        raise ValueError(f"dim {dim} is not divisible by ngroups {ngroups}")
    io_dtype = u.dtype
    if io_dtype not in _DTYPE_CODES:
        raise TypeError(f"u must be float32 or bfloat16, got {io_dtype}")
    bc_shape = ((batch, seqlen, dstate) if B.dim() == 3
                else (batch, seqlen, ngroups, dstate))
    want = {
        "delta": (delta, (batch, seqlen, dim), io_dtype),
        "z": (z, (batch, seqlen, dim), io_dtype),
        "B": (B, bc_shape, io_dtype), "C": (C, bc_shape, io_dtype),
        "A": (A, (dim, dstate), torch.float32),
        "D": (D, (dim,), torch.float32),
        "delta_bias": (delta_bias, (dim,), torch.float32),
        "initial_state": (initial_state, (batch, dim, dstate),
                          torch.float32),
        "u": (u, (batch, seqlen, dim), io_dtype),
    }
    for name, (t, shape, dtype) in want.items():
        if t is None:
            continue
        if t.device != u.device:
            raise ValueError(f"{name} is on {t.device}, u on {u.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return batch, seqlen, dim, dstate, ngroups


def chunked_scan_fwd(
    u: torch.Tensor,
    delta: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    D: Optional[torch.Tensor] = None,
    z: Optional[torch.Tensor] = None,
    delta_bias: Optional[torch.Tensor] = None,
    delta_softplus: bool = False,
    initial_state: Optional[torch.Tensor] = None,
    reverse: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K3 on CUDA tensors: returns (out in u's dtype, last state
    (batch, dim, dstate) fp32).

    u, delta, z: (batch, seqlen, dim) float32 or bfloat16; B, C: (batch,
    seqlen, dstate) or (batch, seqlen, G, dstate) in u's dtype, dim
    divisible by G; A (dim, dstate), D, delta_bias (dim,) and
    initial_state (batch, dim, dstate) float32; dstate <= 16; all
    contiguous and on one device. Raises on anything else.
    """
    if u.device.type != "cuda":
        raise ValueError(f"chunked_scan_fwd launches a CUDA kernel; u is on "
                         f"{u.device}")
    batch, seqlen, dim, dstate, ngroups = _check(
        u, delta, A, B, C, D, z, delta_bias, initial_state)
    out = torch.empty_like(u)
    last = torch.empty(batch, dim, dstate, dtype=torch.float32,
                       device=u.device)
    if u.numel() == 0:
        return out, (last.zero_() if initial_state is None
                     else last.copy_(initial_state))
    launch(KERNEL, library(KERNEL, 8, 11), u.device,
           _DTYPE_CODES[u.dtype], batch, seqlen, dim, dstate, ngroups,
           int(reverse), int(delta_softplus),
           *(ptr(t) for t in (u, delta, z, B, C, A, D, delta_bias,
                              initial_state, out, last)))
    return out, last


class ChunkedScan(torch.autograd.Function):
    """K3 forward. Its adjoint (kernel K4) is ported in a later slice:
    until then a backward raises instead of returning no gradient."""

    @staticmethod
    def forward(ctx, u, delta, A, B, C, D, z, delta_bias, initial_state,
                delta_softplus, reverse):
        out, last = chunked_scan_fwd(u, delta, A, B, C, D, z, delta_bias,
                                     delta_softplus, initial_state, reverse)
        ctx.mark_non_differentiable(last)
        return out, last

    @staticmethod
    def backward(ctx, g_out, g_last):
        raise NotImplementedError(
            "the chunked selective scan has no backward on CUDA yet (kernel "
            "K4 is not ported); run the forward under torch.no_grad() or "
            "inference_mode")
