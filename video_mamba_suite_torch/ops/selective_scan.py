"""Selective SSM scan: the plain PyTorch version and the front end
(counterparts of the JAX package's ``ops/selective_scan.py``:
``selective_scan_ref`` and ``selective_scan``).

Per (batch b, channel d, state n):

    dt_t   = softplus(delta_t + delta_bias)           (optional)
    x_t    = exp(dt_t * A[d,n]) * x_{t-1} + dt_t * B_t[n] * u_t
    y_t[d] = sum_n C_t[n] * x_t[d,n]  (+ D[d] * u_t)  (* silu(z_t), optional)

Layout is time-major ``(batch, seqlen, dim)``, as in the JAX package. The
state and all arithmetic are fp32 (complex64 with complex A, where
y_t = 2·Re(sum_n C_t[n] * x_t[d,n])); the output has u's dtype.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import selective_scan_complex as complex_scan
from . import selective_scan_short as short
from .selective_scan_chunked import CHECKPOINT_STEPS, ChunkedScan


def _flip(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if x is None else torch.flip(x, dims=(1,))


def _expand_bc(bc_t: torch.Tensor, dim: int) -> torch.Tensor:
    """One step's B or C, (batch, dstate) or grouped (batch, G, dstate), as
    (batch, 1 or dim, dstate): channel d takes group d // (dim / G)."""
    if bc_t.dim() == 2:
        return bc_t[:, None, :]
    return bc_t.repeat_interleave(dim // bc_t.shape[1], dim=1)


def selective_scan_ref(
    u: torch.Tensor,
    delta: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    D: Optional[torch.Tensor] = None,
    z: Optional[torch.Tensor] = None,
    delta_bias: Optional[torch.Tensor] = None,
    delta_softplus: bool = False,
    return_last_state: bool = False,
    initial_state: Optional[torch.Tensor] = None,
    reverse: bool = False,
):
    """Sequential single-direction scan (the plain version).

    Args:
      u, delta: (batch, seqlen, dim).
      A: (dim, dstate), already -exp(A_log); real, or complex: then the
        state is complex64 and y_t = 2·Re(sum_n C_t[n] * x_t[d,n]), as the
        JAX ``selective_scan_ref`` gives it.
      B, C: (batch, seqlen, dstate), one per step and shared across
        channels, or grouped (batch, seqlen, G, dstate): channel d uses
        group d // (dim / G). Real, or complex with complex A.
      D: (dim,) skip, optional.
      z: (batch, seqlen, dim) gate, optional (y * silu(z)).
      delta_bias: (dim,), added to delta in fp32, optional.
      delta_softplus: apply softplus to delta (+ bias).
      return_last_state: also return the (batch, dim, dstate) fp32 (or
        complex64) state after the last step.
      initial_state: (batch, dim, dstate) state before the first step,
        optional (zeros); complex with complex A.
      reverse: the anti-causal scan, flip∘scan∘flip: the walk runs from
        t = seqlen - 1 down to 0, the initial state enters at the sequence
        end, and the last state is the one at t = 0.
    """
    if B.dim() not in (3, 4) or C.dim() not in (3, 4):
        raise ValueError("B and C must be (batch, seqlen, dstate) or "
                         "(batch, seqlen, ngroups, dstate), got "
                         f"{tuple(B.shape)} and {tuple(C.shape)}")
    if reverse:
        out = selective_scan_ref(
            _flip(u), _flip(delta), A, _flip(B), _flip(C), D=D, z=_flip(z),
            delta_bias=delta_bias, delta_softplus=delta_softplus,
            return_last_state=return_last_state, initial_state=initial_state)
        if return_last_state:
            return _flip(out[0]), out[1]
        return _flip(out)
    dtype_in = u.dtype
    u = u.float()
    delta = delta.float()
    if delta_bias is not None:
        delta = delta + delta_bias.float()
    if delta_softplus:
        delta = F.softplus(delta)
    state = torch.complex64 if A.is_complex() else torch.float32
    A, B, C = (x.to(torch.complex64) if x.is_complex() else x.float()
               for x in (A, B, C))
    batch, seqlen, dim = u.shape
    if initial_state is None:
        h = u.new_zeros(batch, dim, A.shape[1], dtype=state)
    else:
        h = initial_state.to(state)
    ys = []
    for t in range(seqlen):
        dt = delta[:, t, :, None]                             # (b, d, 1)
        h = (torch.exp(dt * A) * h
             + dt * _expand_bc(B[:, t], dim) * u[:, t, :, None])
        if C.dim() == 3:
            ys.append(torch.einsum("bdn,bn->bd", h, C[:, t].to(h.dtype)))
        else:
            ys.append(torch.einsum("bdn,bdn->bd", h,
                                   _expand_bc(C[:, t], dim).to(h.dtype)))
    y = torch.stack(ys, dim=1) if ys else u.new_zeros(u.shape)
    if y.is_complex():
        y = 2 * y.real
    if D is not None:
        y = y + u * D.float()
    if z is not None:
        y = y * F.silu(z.float())
    y = y.to(dtype_in)
    return (y, h) if return_last_state else y


def selective_scan(
    u: torch.Tensor,
    delta: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    D: Optional[torch.Tensor] = None,
    z: Optional[torch.Tensor] = None,
    delta_bias: Optional[torch.Tensor] = None,
    delta_softplus: bool = False,
    return_last_state: bool = False,
    initial_state: Optional[torch.Tensor] = None,
    reverse: bool = False,
):
    """The scan of ``selective_scan_ref`` (same arguments and results; the
    JAX ``selective_scan`` with ``initial_state`` from
    ``selective_scan_pallas``).

    CPU tensors take the plain version. CUDA tensors take the JAX
    package's routes (``selective_scan_pallas``), each a kernel that raises
    on what it does not take (float32 or bfloat16 I/O, fp32 A, D, bias and
    states, dstate <= 16, contiguous), never a fallback:
    - complex A, first, at any length, with or without ``initial_state``
      (complex64), causal or ``reverse``: the autograd Function
      ``ComplexChunkedScan``, whose forward is kernel K7
      (``complex_scan_fwd``) and whose backward is K7's adjoint K8
      (``complex_scan_bwd``), with the cotangents of the output and of the
      complex last state (assembled outside the Function, so its cotangent
      reaches K8 exactly). B and C must be real, as the JAX kernel takes
      them. K7 writes the checkpoints K8 needs only when a backward
      follows;
    - a scan whose length rounded up to 8 is at most 64, with no
      ``initial_state``, launches kernel K5 (``short_scan_fwd``), causal or
      ``reverse``; with a backward to follow it is the autograd Function
      ``ShortScan``, whose backward launches K5's adjoint K6
      (``short_scan_bwd``) with the output's cotangent only: its last
      state takes no gradient, as the JAX short path stops it;
    - every other scan is the autograd Function ``ChunkedScan``: kernel
      K3 (``chunked_scan_fwd``) and, in a backward, its adjoint K4
      (``chunked_scan_bwd``) with the cotangents of the output and of the
      last state. K3 writes the checkpoints K4 needs only when a backward
      follows.
    A backward follows when grad mode is on and an input requires a
    gradient. The plain version on the CPU gives the last state an exact
    gradient on every route, as the JAX ``impl="ref"`` and ``"assoc"``
    routes do.
    """
    if u.device.type == "cuda":
        out, last = _scan_on_card(u, delta, A, B, C, D, z, delta_bias,
                                  delta_softplus, initial_state, reverse)
        return (out, last) if return_last_state else out
    if u.device.type == "cpu":
        return selective_scan_ref(
            u, delta, A, B, C, D=D, z=z, delta_bias=delta_bias,
            delta_softplus=delta_softplus,
            return_last_state=return_last_state,
            initial_state=initial_state, reverse=reverse)
    raise ValueError(f"unsupported device {u.device}")


def _scan_on_card(u, delta, A, B, C, D, z, delta_bias, delta_softplus,
                  initial_state, reverse):
    """``selective_scan``'s CUDA branch: (out, last state) by the JAX
    routes. It reaches the kernels through their modules' launchers, so a
    test can put the plain versions in their place on the CPU."""
    backward = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad
        for t in (u, delta, A, B, C, D, z, delta_bias, initial_state))
    if A.is_complex():
        return complex_scan.complex_scan(
            u, delta, A, B, C, D, z, delta_bias, delta_softplus,
            initial_state, reverse, backward)
    if short.use_short_scan(u.shape[1], initial_state):
        scan = short.ShortScan.apply if backward else short.short_scan_fwd
        return scan(u, delta, A, B, C, D, z, delta_bias, delta_softplus,
                    reverse)
    return ChunkedScan.apply(
        u, delta, A, B, C, D, z, delta_bias, initial_state, delta_softplus,
        reverse, CHECKPOINT_STEPS if backward else 0)
