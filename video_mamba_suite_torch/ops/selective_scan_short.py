"""Short selective scan, forward, one direction (kernel K5).

Counterpart of the JAX package's ``_short_core`` with its Pallas kernel
``_short_fwd_kernel`` (``video_mamba_suite_tpu/ops/selective_scan_pallas.py``):
one direction of a selective scan for sequences whose length, rounded up
to 8, is at most ``SHORT_SEQ_MAX`` = 64, with no initial state; it returns
the output and the last state. The anti-causal direction (``reverse``)
walks backwards in the kernel, where the JAX package reaches it through
flips. ``csrc/short_scan_fwd.cu`` is the kernel.

``short_scan_fwd`` launches it on CUDA tensors and raises on anything it
does not take; ``short_scan_fwd_ref`` is its plain version.
``ops.selective_scan.selective_scan`` is the front end that picks K5 or
the chunked scan (K3/K4) by ``use_short_scan``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ._build import launch, library, ptr
from .selective_scan_chunked import _DTYPE_CODES, _check

KERNEL = "short_scan_fwd"
SHORT_SEQ_MAX = 64   # longest sequence (rounded up to 8) of the short scans


def use_short_scan(seqlen: int,
                   initial_state: Optional[torch.Tensor] = None,
                   backward: bool = False) -> bool:
    """The JAX package's route to the short kernels: the length rounded up
    to 8 is at most ``SHORT_SEQ_MAX`` and there is no initial state. A
    one-direction scan with a ``backward`` to follow stays on the chunked
    scan until K5's adjoint (K6) is ported."""
    return (-(-seqlen // 8) * 8 <= SHORT_SEQ_MAX and initial_state is None
            and not backward)


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
    if u.device.type != "cuda":
        raise ValueError(f"short_scan_fwd launches a CUDA kernel; u is on "
                         f"{u.device}")
    if initial_state is not None:
        raise ValueError("short_scan_fwd starts from a zero state; a scan "
                         "with an initial_state takes the chunked scan")
    batch, seqlen, dim, dstate, ngroups = _check(
        u, delta, A, B, C, D, z, delta_bias, None)
    if seqlen > SHORT_SEQ_MAX:
        raise ValueError(f"seqlen {seqlen} > {SHORT_SEQ_MAX}: the short "
                         "scan takes at most 64 steps")
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
