"""Short selective scan, one direction: forward (kernel K5) and backward
(kernel K6).

Counterpart of the JAX package's ``_short_core`` with its ``custom_vjp``
and Pallas kernels ``_short_fwd_kernel`` and ``_short_bwd_kernel``
(``video_mamba_suite_tpu/ops/selective_scan_pallas.py``): one direction of
a selective scan for sequences whose length, rounded up to 8, is at most
``SHORT_SEQ_MAX`` = 64, with no initial state; it returns the output and
the last state, and its adjoint takes the output's cotangent only (the
JAX package stops the last state's gradient). The anti-causal direction
(``reverse``) walks backwards in both kernels, where the JAX package
reaches it through flips. ``csrc/short_scan_fwd.cu`` and
``csrc/short_scan_bwd.cu`` are the kernels.

``short_scan_fwd`` and ``short_scan_bwd`` launch them on CUDA tensors and
raise on anything they do not take; ``short_scan_fwd_ref`` and
``short_scan_bwd_ref`` are their plain versions. ``ShortScan`` is the
autograd Function (K5 forward, K6 backward).
``ops.selective_scan.selective_scan`` is the front end that picks these or
the chunked scan (K3/K4) by ``use_short_scan``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ._build import launch, library, ptr
from .selective_scan_chunked import _DTYPE_CODES, _check, chunked_scan_bwd_ref

KERNEL = "short_scan_fwd"
BWD_KERNEL = "short_scan_bwd"
SHORT_SEQ_MAX = 64   # longest sequence (rounded up to 8) of the short scans
BWD_ROW_GROUPS = 256  # most row groups (partials of dA, dD, dbias) of K6
BWD_TILE = 32         # channels of a K6 block (one dB/dC partial)


def use_short_scan(seqlen: int,
                   initial_state: Optional[torch.Tensor] = None) -> bool:
    """The JAX package's route to the short kernels: the length rounded up
    to 8 is at most ``SHORT_SEQ_MAX`` and there is no initial state."""
    return -(-seqlen // 8) * 8 <= SHORT_SEQ_MAX and initial_state is None


def short_scan_fwd_ref(u, delta, A, B, C, D=None, z=None, delta_bias=None,
                       delta_softplus=False, reverse=False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K5: ``selective_scan_ref`` with the last state,
    (out in u's dtype, last state (batch, dim, dstate) fp32)."""
    from .selective_scan import selective_scan_ref

    return selective_scan_ref(
        u, delta, A, B, C, D=D, z=z, delta_bias=delta_bias,
        delta_softplus=delta_softplus, return_last_state=True,
        reverse=reverse)


def _check_short(name, u, delta, A, B, C, D, z, delta_bias, initial_state,
                 **more):
    """Raise unless the short kernels take these arguments; return (batch,
    seqlen, dim, dstate, ngroups)."""
    if u.device.type != "cuda":
        raise ValueError(f"{name} launches a CUDA kernel; u is on "
                         f"{u.device}")
    if initial_state is not None:
        raise ValueError(f"{name} starts from a zero state; a scan with an "
                         "initial_state takes the chunked scan")
    dims = _check(u, delta, A, B, C, D, z, delta_bias, None, **more)
    if dims[1] > SHORT_SEQ_MAX:
        raise ValueError(f"seqlen {dims[1]} > {SHORT_SEQ_MAX}: the short "
                         "scan takes at most 64 steps")
    return dims


def short_scan_fwd(
    u: torch.Tensor,
    delta: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    D: Optional[torch.Tensor] = None,
    z: Optional[torch.Tensor] = None,
    delta_bias: Optional[torch.Tensor] = None,
    delta_softplus: bool = False,
    reverse: bool = False,
    initial_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K5 on CUDA tensors: returns (out in u's dtype, last state
    (batch, dim, dstate) fp32), the state after the walk's last step.

    u, delta, z: (batch, seqlen, dim) float32 or bfloat16, seqlen <= 64;
    B, C: (batch, seqlen, dstate) or (batch, seqlen, G, dstate) in u's
    dtype, dim divisible by G; A (dim, dstate), D and delta_bias (dim,)
    float32; dstate <= 16; all contiguous and on one device. The kernel
    starts from a zero state, so an ``initial_state`` is refused (the
    chunked scan takes one). Raises on anything else.
    """
    batch, seqlen, dim, dstate, ngroups = _check_short(
        "short_scan_fwd", u, delta, A, B, C, D, z, delta_bias, initial_state)
    out = torch.empty_like(u)
    last = torch.empty(batch, dim, dstate, dtype=torch.float32,
                       device=u.device)
    if u.numel() == 0:
        return out, last.zero_()
    launch(KERNEL, library(KERNEL, 8, 10), u.device,
           _DTYPE_CODES[u.dtype], batch, seqlen, dim, dstate, ngroups,
           int(reverse), int(delta_softplus),
           *(ptr(t) for t in (u, delta, z, B, C, A, D, delta_bias, out,
                              last)))
    return out, last


GRADS = ("u", "delta", "A", "B", "C", "D", "z", "delta_bias")


def short_scan_bwd_ref(u, delta, A, B, C, D=None, z=None, delta_bias=None,
                       g=None, delta_softplus=False, reverse=False):
    """Plain version of K6: the VJP of ``short_scan_fwd_ref`` for the
    cotangent ``g`` of the output, the last state's cotangent zero (the
    JAX ``_short_core_bwd`` drops it).

    Returns (du, ddelta, dA, dB, dC, dD, dz, ddelta_bias), the JAX order,
    each in its input's dtype and shape, None for an input that is None.
    """
    return chunked_scan_bwd_ref(u, delta, A, B, C, D, z, delta_bias, None,
                                g, None, delta_softplus, reverse)[:8]


def short_scan_bwd(u, delta, A, B, C, D=None, z=None, delta_bias=None,
                   g=None, delta_softplus=False, reverse=False,
                   initial_state=None):
    """Launch K6 on CUDA tensors: the gradients of ``short_scan_fwd`` at
    its eight inputs for the cotangent ``g`` (u's shape and dtype,
    contiguous) of the output; the last state takes no cotangent.

    Returns the order and dtypes of ``short_scan_bwd_ref``: du, ddelta, dz
    in u's dtype, dB, dC in B's dtype and shape (summed in fp32), dA, dD
    and ddelta_bias fp32; None for an input that is None. Raises on what
    K5 refuses (``initial_state`` included) and on a missing ``g``.
    """
    if g is None:
        raise ValueError("short_scan_bwd needs the output's cotangent g")
    batch, seqlen, dim, dstate, ngroups = _check_short(
        "short_scan_bwd", u, delta, A, B, C, D, z, delta_bias, initial_state,
        g=(g, tuple(u.shape), u.dtype))
    groups = max(1, min(batch, BWD_ROW_GROUPS))
    tiles = -(-(dim // ngroups) // BWD_TILE)
    f32 = dict(dtype=torch.float32, device=u.device)
    # the kernel writes every element of its outputs and partials
    alloc = torch.empty if u.numel() else torch.zeros
    du, ddelta = torch.empty_like(u), torch.empty_like(u)
    dz = None if z is None else torch.empty_like(z)
    dA = alloc(groups, dim, dstate, **f32)
    dB = alloc(tiles, batch, seqlen, ngroups, dstate, **f32)
    dC = alloc(tiles, batch, seqlen, ngroups, dstate, **f32)
    dD = None if D is None else alloc(groups, dim, **f32)
    dbias = None if delta_bias is None else alloc(groups, dim, **f32)
    if u.numel():
        launch(BWD_KERNEL, library(BWD_KERNEL, 9, 17), u.device,
               _DTYPE_CODES[u.dtype], batch, seqlen, dim, dstate, ngroups,
               groups, int(reverse), int(delta_softplus),
               *(ptr(t) for t in (u, delta, z, B, C, A, D, delta_bias, g,
                                  du, ddelta, dz, dA, dB, dC, dD, dbias)))
    return (du, ddelta, dA.sum(0),
            dB.sum(0).reshape(B.shape).to(B.dtype),
            dC.sum(0).reshape(C.shape).to(C.dtype),
            None if D is None else dD.sum(0), dz,
            None if delta_bias is None else dbias.sum(0))


class ShortScan(torch.autograd.Function):
    """K5 forward, K6 backward: the JAX ``_short_core`` with its
    ``custom_vjp``. The forward saves its eight inputs (the JAX residuals);
    the last state is returned but takes no gradient, as the JAX short
    path stops it (``lax.stop_gradient``)."""

    @staticmethod
    def forward(ctx, u, delta, A, B, C, D, z, delta_bias, delta_softplus,
                reverse):
        out, last = short_scan_fwd(u, delta, A, B, C, D, z, delta_bias,
                                   delta_softplus, reverse)
        ctx.mark_non_differentiable(last)
        ctx.delta_softplus = delta_softplus
        ctx.reverse = reverse
        ctx.save_for_backward(u, delta, A, B, C, D, z, delta_bias)
        return out, last

    @staticmethod
    def backward(ctx, g_out, _g_last):
        grads = short_scan_bwd(*ctx.saved_tensors, g=g_out.contiguous(),
                               delta_softplus=ctx.delta_softplus,
                               reverse=ctx.reverse)
        return tuple(gr if need else None for gr, need in
                     zip(grads, ctx.needs_input_grad)) + (None, None)
