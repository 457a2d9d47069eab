"""Chunked selective scan, forward and backward (kernels K3 and K4).

Counterpart of the JAX package's ``_scan_fwd_impl`` and ``_scan_core_bwd``
with their Pallas kernels ``_fwd_kernel``/``_fwd_kernel_hs`` and
``_bwd_kernel``/``_bwd_kernel_hs``
(``video_mamba_suite_tpu/ops/selective_scan_pallas.py``): one direction of
a selective scan at any length, causal or anti-causal (``reverse``), with
an initial state, the last state, and per-step B/C shared by all channels
or by groups of channels, and its adjoint. One CUDA kernel computes each
direction of the work for every batch size: ``csrc/chunked_scan_fwd.cu``
the forward, ``csrc/chunked_scan_bwd.cu`` the backward.

``chunked_scan_fwd`` and ``chunked_scan_bwd`` launch the kernels on CUDA
tensors and raise on anything they do not take. ``ops.selective_scan.
selective_scan`` is the front end: it takes the plain version for CPU
tensors and, for CUDA tensors, the autograd Function ``ChunkedScan``. When
a backward will follow, its forward asks K3 for checkpoints (the state
before every ``CHECKPOINT_STEPS``-th step of the walk) and its backward
runs K4 from them, with the cotangents of both the output and the last
state; otherwise K3 writes no checkpoints.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ._build import launch, library, ptr

KERNEL = "chunked_scan_fwd"
BWD_KERNEL = "chunked_scan_bwd"
MAX_DSTATE = 16      # largest state size the kernels take
# walk steps between K3's checkpoints for K4 (a multiple of 4, at most
# 64): 16 is two of K4's 8-step pieces, so its main pass takes 1.5 forward
# steps per step, and keeps the checkpoints at the size of one fp32
# (batch, seqlen, dim) tensor
CHECKPOINT_STEPS = 16
BWD_CHUNKS_PER_BLOCK = 8  # K4: chunks per block (one dA/dD/dbias partial)
BWD_TILE = 32        # K4: channels per block (one dB/dC partial)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check(u, delta, A, B, C, D, z, delta_bias, initial_state, **more):
    """Raise unless the kernels take these arguments (``more``: further
    (tensor, shape, dtype) to check); return (batch, seqlen, dim, dstate,
    ngroups)."""
    if u.dim() != 3:
        raise ValueError(f"u must be (batch, seqlen, dim), got "
                         f"{tuple(u.shape)}")
    batch, seqlen, dim = u.shape
    if A.is_complex() or B.is_complex() or C.is_complex():
        raise TypeError("complex A, B or C is not supported by the real "
                        "scans (complex A is kernel K7, "
                        "ops/selective_scan_complex.py)")
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
        **more,
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
    checkpoint_steps: int = 0,
) -> Tuple[torch.Tensor, ...]:
    """Launch K3 on CUDA tensors: returns (out in u's dtype, last state
    (batch, dim, dstate) fp32) and, with ``checkpoint_steps`` S > 0, the
    checkpoints: fp32 (batch, ceil(seqlen / S), dim, dstate), the state
    before walk steps 0, S, 2·S, ... (the first is the initial state).

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
    if checkpoint_steps < 0:
        raise ValueError(f"checkpoint_steps must be >= 0, got "
                         f"{checkpoint_steps}")
    out = torch.empty_like(u)
    last = torch.empty(batch, dim, dstate, dtype=torch.float32,
                       device=u.device)
    states = None
    if checkpoint_steps:
        states = torch.empty(batch, -(-seqlen // checkpoint_steps), dim,
                             dstate, dtype=torch.float32, device=u.device)
    if u.numel() == 0:
        last = (last.zero_() if initial_state is None
                else last.copy_(initial_state))
        if states is not None:
            states.copy_(last[:, None].expand_as(states))
    else:
        launch(KERNEL, library(KERNEL, 9, 12), u.device,
               _DTYPE_CODES[u.dtype], batch, seqlen, dim, dstate, ngroups,
               int(reverse), int(delta_softplus), checkpoint_steps,
               *(ptr(t) for t in (u, delta, z, B, C, A, D, delta_bias,
                                  initial_state, out, last, states)))
    return (out, last) if states is None else (out, last, states)


def chunked_scan_states_ref(u, delta, A, B, C, delta_bias=None,
                            delta_softplus=False, initial_state=None,
                            reverse=False,
                            checkpoint_steps=CHECKPOINT_STEPS):
    """Plain version of K3's checkpoints: the fp32 state before walk steps
    0, S, 2·S, ... (S = ``checkpoint_steps``), (batch, ceil(seqlen / S),
    dim, dstate), from ``selective_scan_ref`` over the walk's chunks."""
    from .selective_scan import selective_scan_ref

    if reverse:     # the walk of the anti-causal scan, in walk order
        u, delta, B, C = (torch.flip(x, dims=(1,)) for x in (u, delta, B, C))
    batch, seqlen, dim = u.shape
    h = (u.new_zeros(batch, dim, A.shape[1], dtype=torch.float32)
         if initial_state is None else initial_state.float())
    states = []
    for i in range(0, seqlen, checkpoint_steps):
        states.append(h)
        sl = slice(i, i + checkpoint_steps)
        _, h = selective_scan_ref(
            u[:, sl], delta[:, sl], A, B[:, sl], C[:, sl],
            delta_bias=delta_bias, delta_softplus=delta_softplus,
            return_last_state=True, initial_state=h)
    return torch.stack(states, dim=1)


GRADS = ("u", "delta", "A", "B", "C", "D", "z", "delta_bias",
         "initial_state")


def chunked_scan_bwd_ref(u, delta, A, B, C, D=None, z=None, delta_bias=None,
                         initial_state=None, g=None, g_last=None,
                         delta_softplus=False, reverse=False):
    """Plain version of K4: the VJP of ``selective_scan_ref`` (with the last
    state) at its nine inputs for the cotangents ``g`` of the output and
    ``g_last`` of the last state (either may be None: zeros).

    Returns (du, ddelta, dA, dB, dC, dD, dz, ddelta_bias, dinitial_state),
    each in its input's dtype and shape, None for an input that is None.
    """
    from .selective_scan import selective_scan_ref

    given = dict(zip(GRADS, (u, delta, A, B, C, D, z, delta_bias,
                             initial_state)))
    with torch.enable_grad():
        leaves = {k: v.detach().requires_grad_()
                  for k, v in given.items() if v is not None}
        out, last = selective_scan_ref(
            **{k: leaves.get(k) for k in GRADS},
            delta_softplus=delta_softplus, return_last_state=True,
            reverse=reverse)
        pairs = [(o, c) for o, c in ((out, g), (last, g_last))
                 if c is not None] or [(out, torch.zeros_like(out))]
        outs, cots = zip(*pairs)
        found = torch.autograd.grad(outs, list(leaves.values()), cots,
                                    allow_unused=True)
    found = {k: (torch.zeros_like(leaves[k]) if v is None else v)
             for k, v in zip(leaves, found)}
    return tuple(found.get(name) for name in GRADS)


def chunked_scan_bwd(u, delta, A, B, C, D=None, z=None, delta_bias=None,
                     initial_state=None, states=None, g=None, g_last=None,
                     delta_softplus=False, reverse=False,
                     checkpoint_steps=CHECKPOINT_STEPS):
    """Launch K4 on CUDA tensors: the gradients of ``chunked_scan_fwd`` at
    its nine inputs from the checkpoints ``states`` that it wrote with
    ``checkpoint_steps`` (a multiple of 4, at most 64), for the cotangents
    ``g`` (u's shape and dtype, contiguous) of the output and ``g_last``
    ((batch, dim, dstate) fp32, or None: zeros) of the last state.

    Returns the order and dtypes of ``chunked_scan_bwd_ref``: du, ddelta,
    dz in u's dtype, dB, dC in B's dtype and shape (summed in fp32), dA,
    dD, ddelta_bias and dinitial_state fp32; None for an input that is
    None. Raises on anything the kernel does not take.
    """
    if checkpoint_steps < 4 or checkpoint_steps > 64 or checkpoint_steps % 4:
        raise ValueError(f"checkpoint_steps must be a multiple of 4 in "
                         f"[4, 64], got {checkpoint_steps}")
    if u.device.type != "cuda":
        raise ValueError(f"chunked_scan_bwd launches a CUDA kernel; u is on "
                         f"{u.device}")
    if states is None or g is None:
        raise ValueError("chunked_scan_bwd needs the forward's checkpoints "
                         "(states) and the output's cotangent g")
    batch, seqlen, dim = u.shape
    dstate = A.shape[1] if A.dim() == 2 else 0
    nchunks = -(-seqlen // checkpoint_steps)
    batch, seqlen, dim, dstate, ngroups = _check(
        u, delta, A, B, C, D, z, delta_bias, initial_state,
        states=(states, (batch, nchunks, dim, dstate), torch.float32),
        g=(g, (batch, seqlen, dim), u.dtype),
        g_last=(g_last, (batch, dim, dstate), torch.float32))
    f32 = dict(dtype=torch.float32, device=u.device)
    du, ddelta = torch.empty_like(u), torch.empty_like(u)
    dz = None if z is None else torch.empty_like(z)
    if u.numel() == 0:
        zero = [torch.zeros_like(t) if t is not None else None
                for t in (A, B, C, D, delta_bias)]
        dh0 = None
        if initial_state is not None:
            dh0 = (torch.zeros_like(initial_state) if g_last is None
                   else g_last.clone())
        return (du, ddelta, zero[0], zero[1], zero[2], zero[3], dz,
                zero[4], dh0)
    parts = batch * -(-nchunks // BWD_CHUNKS_PER_BLOCK)
    tiles = -(-(dim // ngroups) // BWD_TILE)
    dA = torch.empty(parts, dim, dstate, **f32)
    dB = torch.empty(tiles, batch, seqlen, ngroups, dstate, **f32)
    dC = torch.empty_like(dB)
    dD = None if D is None else torch.empty(parts, dim, **f32)
    dbias = None if delta_bias is None else torch.empty(parts, dim, **f32)
    dh0 = torch.empty(batch, dim, dstate, **f32)
    carry = torch.empty(batch, nchunks, dim, dstate, **f32)
    dtsum = torch.empty(batch, nchunks, dim, **f32)
    launch(BWD_KERNEL, library(BWD_KERNEL, 9, 22), u.device,
           _DTYPE_CODES[u.dtype], batch, seqlen, dim, dstate, ngroups,
           int(reverse), int(delta_softplus), checkpoint_steps,
           *(ptr(t) for t in (u, delta, z, B, C, A, D, delta_bias, states,
                              g, g_last, du, ddelta, dz, dA, dB, dC, dD,
                              dbias, dh0, carry, dtsum)))
    return (du, ddelta, dA.sum(0),
            dB.sum(0).reshape(B.shape).to(B.dtype),
            dC.sum(0).reshape(C.shape).to(C.dtype),
            None if D is None else dD.sum(0), dz,
            None if delta_bias is None else dbias.sum(0),
            None if initial_state is None else dh0)


class ChunkedScan(torch.autograd.Function):
    """K3 forward, K4 backward. With ``checkpoint_steps`` > 0 the forward
    writes K3's checkpoints and saves them with the inputs; the backward
    takes the cotangents of both outputs (the last state's is exact, as in
    the JAX package). The front end passes 0 when no backward will follow
    (grad mode off, or no input that requires a gradient)."""

    @staticmethod
    def forward(ctx, u, delta, A, B, C, D, z, delta_bias, initial_state,
                delta_softplus, reverse, checkpoint_steps):
        outs = chunked_scan_fwd(u, delta, A, B, C, D, z, delta_bias,
                                delta_softplus, initial_state, reverse,
                                checkpoint_steps)
        ctx.delta_softplus = delta_softplus
        ctx.reverse = reverse
        ctx.checkpoint_steps = checkpoint_steps
        if checkpoint_steps:
            ctx.save_for_backward(u, delta, A, B, C, D, z, delta_bias,
                                  initial_state, outs[2])
        return outs[0], outs[1]

    @staticmethod
    def backward(ctx, g_out, g_last):
        if not ctx.checkpoint_steps:
            raise RuntimeError("ChunkedScan ran its forward without "
                               "checkpoints (checkpoint_steps=0), so it has "
                               "no backward")
        *inputs, states = ctx.saved_tensors
        grads = chunked_scan_bwd(
            *inputs, states, g_out.contiguous(), g_last,
            ctx.delta_softplus, ctx.reverse, ctx.checkpoint_steps)
        return tuple(gr if need else None for gr, need in
                     zip(grads, ctx.needs_input_grad)) + (None,) * 3
