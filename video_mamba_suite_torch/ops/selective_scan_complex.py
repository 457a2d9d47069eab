"""Selective scan with complex A, forward and backward (kernels K7 and K8).

Counterpart of the JAX package's complex-A path in
``ops/selective_scan_pallas.py``: ``_complex_fwd_impl`` with its Pallas
kernel ``_cfwd_kernel`` and ``_complex_core_bwd`` with ``_cbwd_kernel``.
The recurrence runs in two real channels, per (row, channel, state):

    a_t  = exp(dt_t·Ar) · (cos(dt_t·Ai) + i·sin(dt_t·Ai))
    hr_t = Re(a_t)·hr_{t-1} - Im(a_t)·hi_{t-1} + dt_t·B_t·u_t
    hi_t = Im(a_t)·hr_{t-1} + Re(a_t)·hi_{t-1}
    y_t  = (2·sum_n C_t·hr_t + D·u_t) · silu(z_t)

with dt_t = softplus(delta_t + bias) (softplus optional), real B and C
(per step, shared by all channels or by groups of channels), the initial
state h0r + i·h0i and the last state lastr + i·lasti. ``reverse`` walks
t = L-1 .. 0 (the JAX package composes it from flips; the kernels walk
backwards, which is the same function).

``csrc/complex_scan_fwd.cu`` holds K7 (``complex_scan_fwd_lanes``: 4
lanes a channel, the walk split in time into segments combined in a
thread block cluster where the grid would leave half the card idle),
``csrc/complex_scan_bwd.cu`` K8 (three kernels on the stream:
``complex_scan_bwd_local_lanes``, ``complex_scan_bwd_combine``,
``complex_scan_bwd_main_lanes``, walking the chunks between K7's
checkpoints in parallel). ``complex_scan_fwd`` and ``complex_scan_bwd``
launch them on CUDA tensors
and raise on anything they do not take; ``complex_scan_fwd_ref`` and
``complex_scan_bwd_ref`` are the plain versions. ``ComplexChunkedScan`` is
the autograd Function on the real leaves (u, delta, Ar, Ai, B, C, D, z,
bias, h0r, h0i), the JAX ``_complex_core``: K7 forward and K8 backward on
CUDA, the plain versions on the CPU. ``complex_scan`` is
``selective_scan``'s complex-A route on the card.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ._build import launch, library, ptr

KERNEL = "complex_scan_fwd"
BWD_KERNEL = "complex_scan_bwd"
MAX_DSTATE = 16      # 16 complex states: 4 lanes of 4 a channel
# walk steps between K7's checkpoints: K8's chunks, each walked from its
# checkpoint (its states and decays in registers 4 steps at a time)
CHECKPOINT_STEPS = 16
CHUNKS_PER_BLOCK = 8  # K8's chunks a block: its partials per row

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

GRADS = ("u", "delta", "Ar", "Ai", "B", "C", "D", "z", "delta_bias", "h0r",
         "h0i")


def _check(u, delta, Ar, Ai, B, C, D, z, delta_bias, h0r, h0i, **more):
    """Raise unless K7 and K8 take these arguments (``more``: further
    (tensor, shape, dtype) to check); return (batch, seqlen, dim, dstate,
    ngroups)."""
    if u.dim() != 3:
        raise ValueError(f"u must be (batch, seqlen, dim), got "
                         f"{tuple(u.shape)}")
    batch, seqlen, dim = u.shape
    if B.is_complex() or C.is_complex():
        raise TypeError("complex B or C is not supported by the complex-A "
                        "kernels K7/K8 (real B and C only, as in the JAX "
                        "kernel)")
    if Ar.dim() != 2 or Ar.shape[0] != dim:
        raise ValueError(f"Ar must be (dim, dstate), got {tuple(Ar.shape)}")
    dstate = Ar.shape[1]
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
    state = (batch, dim, dstate)
    want = {
        "delta": (delta, (batch, seqlen, dim), io_dtype),
        "z": (z, (batch, seqlen, dim), io_dtype),
        "B": (B, bc_shape, io_dtype), "C": (C, bc_shape, io_dtype),
        "Ar": (Ar, (dim, dstate), torch.float32),
        "Ai": (Ai, (dim, dstate), torch.float32),
        "D": (D, (dim,), torch.float32),
        "delta_bias": (delta_bias, (dim,), torch.float32),
        "h0r": (h0r, state, torch.float32),
        "h0i": (h0i, state, torch.float32),
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


def complex_scan_fwd(u, delta, Ar, Ai, B, C, D=None, z=None,
                     delta_bias=None, h0r=None, h0i=None,
                     delta_softplus=False, reverse=False,
                     checkpoint_steps=0) -> Tuple[torch.Tensor, ...]:
    """Launch K7 on CUDA tensors: returns (out in u's dtype, lastr, lasti
    fp32 (batch, dim, dstate)) and, with ``checkpoint_steps`` S > 0, the
    checkpoints statesr and statesi: fp32 (batch, ceil(seqlen / S), dim,
    dstate), the state before walk steps 0, S, 2·S, ...

    u, delta, z: (batch, seqlen, dim) float32 or bfloat16; B, C: real
    (batch, seqlen, dstate) or (batch, seqlen, G, dstate) in u's dtype;
    Ar, Ai (dim, dstate), D, delta_bias (dim,), h0r and h0i (batch, dim,
    dstate) float32 (h0r and h0i both or neither); dstate <= 16; all
    contiguous and on one device. Raises on anything else.
    """
    if u.device.type != "cuda":
        raise ValueError(f"complex_scan_fwd launches a CUDA kernel; u is on "
                         f"{u.device}")
    if (h0r is None) != (h0i is None):
        raise ValueError("give h0r and h0i both or neither")
    batch, seqlen, dim, dstate, ngroups = _check(
        u, delta, Ar, Ai, B, C, D, z, delta_bias, h0r, h0i)
    if checkpoint_steps < 0:
        raise ValueError(f"checkpoint_steps must be >= 0, got "
                         f"{checkpoint_steps}")
    f32 = dict(dtype=torch.float32, device=u.device)
    out = torch.empty_like(u)
    lastr = torch.empty(batch, dim, dstate, **f32)
    lasti = torch.empty_like(lastr)
    states = ()
    if checkpoint_steps:
        nchunks = -(-seqlen // checkpoint_steps)
        states = tuple(torch.empty(batch, nchunks, dim, dstate, **f32)
                       for _ in range(2))
    if u.numel() == 0:
        for last, h0 in ((lastr, h0r), (lasti, h0i)):
            last.zero_() if h0 is None else last.copy_(h0)
        for st, last in zip(states, (lastr, lasti)):
            st.copy_(last[:, None].expand_as(st))
    else:
        statesr, statesi = states or (None, None)
        launch(KERNEL, library(KERNEL, 9, 16), u.device,
               _DTYPE_CODES[u.dtype], batch, seqlen, dim, dstate, ngroups,
               int(reverse), int(delta_softplus), checkpoint_steps,
               *(ptr(t) for t in (u, delta, z, B, C, Ar, Ai, D, delta_bias,
                                  h0r, h0i, out, lastr, lasti, statesr,
                                  statesi)))
    return (out, lastr, lasti) + states


def complex_scan_fwd_ref(u, delta, Ar, Ai, B, C, D=None, z=None,
                         delta_bias=None, h0r=None, h0i=None,
                         delta_softplus=False, reverse=False,
                         checkpoint_steps=CHECKPOINT_STEPS):
    """Plain version of K7 with its checkpoints: (out, lastr, lasti,
    statesr, statesi), from ``selective_scan_ref`` with A = Ar + i·Ai over
    the walk's segments of ``checkpoint_steps`` steps."""
    from .selective_scan import selective_scan_ref

    A = torch.complex(Ar.float(), Ai.float())
    h = None if h0r is None else torch.complex(h0r.float(), h0i.float())
    kw = dict(delta_bias=delta_bias, delta_softplus=delta_softplus)
    out, last = selective_scan_ref(u, delta, A, B, C, D=D, z=z,
                                   return_last_state=True, initial_state=h,
                                   reverse=reverse, **kw)
    if reverse:     # the walk of the anti-causal scan, in walk order
        u, delta, B, C = (torch.flip(x, dims=(1,)) for x in (u, delta, B, C))
    batch, seqlen, dim = u.shape
    if h is None:
        h = torch.zeros(batch, dim, Ar.shape[1], dtype=torch.complex64,
                        device=u.device)
    states = []
    for i in range(0, seqlen, checkpoint_steps):
        states.append(h)
        sl = slice(i, i + checkpoint_steps)
        _, h = selective_scan_ref(u[:, sl], delta[:, sl], A, B[:, sl],
                                  C[:, sl], return_last_state=True,
                                  initial_state=h, **kw)
    states = (torch.stack(states, dim=1) if states
              else h.new_zeros(batch, 0, dim, Ar.shape[1]))
    return (out, last.real.contiguous(), last.imag.contiguous(),
            states.real.contiguous(), states.imag.contiguous())


def complex_scan_bwd_ref(u, delta, Ar, Ai, B, C, D=None, z=None,
                         delta_bias=None, h0r=None, h0i=None, g=None,
                         glastr=None, glasti=None, delta_softplus=False,
                         reverse=False):
    """Plain version of K8: the VJP of ``complex_scan_fwd_ref`` at its real
    leaves for the cotangents ``g`` of the output and ``glastr``,
    ``glasti`` of the last state's two channels (None: zeros).

    Returns, in the order of the JAX ``_complex_core_bwd``, (du, ddelta,
    dAr, dAi, dB, dC, dD, dz, ddelta_bias, dh0r, dh0i), each in its input's
    dtype and shape; dh0r and dh0i always (the initial state's gradient,
    zeros for h0 when it is None), None for any other input that is None.
    """
    from .selective_scan import selective_scan_ref

    batch, _, dim = u.shape
    if h0r is None:
        h0r = h0i = torch.zeros(batch, dim, Ar.shape[1], dtype=torch.float32,
                                device=u.device)
    given = dict(zip(GRADS, (u, delta, Ar, Ai, B, C, D, z, delta_bias, h0r,
                             h0i)))
    with torch.enable_grad():
        leaves = {k: v.detach().requires_grad_()
                  for k, v in given.items() if v is not None}
        out, last = selective_scan_ref(
            leaves["u"], leaves["delta"],
            torch.complex(leaves["Ar"], leaves["Ai"]), leaves["B"],
            leaves["C"], D=leaves.get("D"), z=leaves.get("z"),
            delta_bias=leaves.get("delta_bias"),
            delta_softplus=delta_softplus, return_last_state=True,
            initial_state=torch.complex(leaves["h0r"], leaves["h0i"]),
            reverse=reverse)
        pairs = [(o, c) for o, c in ((out, g), (last.real, glastr),
                                     (last.imag, glasti)) if c is not None]
        pairs = pairs or [(out, torch.zeros_like(out))]
        outs, cots = zip(*pairs)
        found = torch.autograd.grad(outs, list(leaves.values()), cots,
                                    allow_unused=True)
    found = {k: (torch.zeros_like(leaves[k]) if v is None else v)
             for k, v in zip(leaves, found)}
    return tuple(found.get(name) for name in GRADS)


def complex_scan_bwd(u, delta, Ar, Ai, B, C, D=None, z=None, delta_bias=None,
                     statesr=None, statesi=None, g=None, glastr=None,
                     glasti=None, delta_softplus=False, reverse=False,
                     checkpoint_steps=CHECKPOINT_STEPS):
    """Launch K8 on CUDA tensors: the gradients of ``complex_scan_fwd`` at
    its real leaves from the checkpoints ``statesr``, ``statesi`` that it
    wrote with ``checkpoint_steps`` (1 to 16), for the cotangents ``g``
    (u's shape and dtype, contiguous) of the output and ``glastr``,
    ``glasti`` ((batch, dim, dstate) fp32, or None: zeros) of the last
    state.

    Returns the order and dtypes of ``complex_scan_bwd_ref``: du, ddelta,
    dz in u's dtype, dB, dC in B's dtype and shape (summed in fp32), dAr,
    dAi, dD, ddelta_bias, dh0r and dh0i fp32; None for D, z or delta_bias
    when it is None. Raises on anything the kernel does not take.
    """
    if not 1 <= checkpoint_steps <= CHECKPOINT_STEPS:
        raise ValueError(f"checkpoint_steps must be in [1, "
                         f"{CHECKPOINT_STEPS}], got {checkpoint_steps}")
    if u.device.type != "cuda":
        raise ValueError(f"complex_scan_bwd launches a CUDA kernel; u is on "
                         f"{u.device}")
    if statesr is None or statesi is None or g is None:
        raise ValueError("complex_scan_bwd needs the forward's checkpoints "
                         "(statesr, statesi) and the output's cotangent g")
    if (glastr is None) != (glasti is None):
        raise ValueError("give glastr and glasti both or neither")
    batch, seqlen, dim = u.shape
    dstate = Ar.shape[1] if Ar.dim() == 2 else 0
    st = ((batch, -(-seqlen // checkpoint_steps), dim, dstate),
          torch.float32)
    state = ((batch, dim, dstate), torch.float32)
    batch, seqlen, dim, dstate, ngroups = _check(
        u, delta, Ar, Ai, B, C, D, z, delta_bias, None, None,
        statesr=(statesr, *st), statesi=(statesi, *st),
        g=(g, (batch, seqlen, dim), u.dtype),
        glastr=(glastr, *state), glasti=(glasti, *state))
    f32 = dict(dtype=torch.float32, device=u.device)
    du, ddelta = torch.empty_like(u), torch.empty_like(u)
    dz = None if z is None else torch.empty_like(z)
    if u.numel() == 0:
        zero = [None if t is None else torch.zeros_like(t)
                for t in (Ar, Ai, B, C, D, delta_bias)]
        dh0 = [torch.zeros(batch, dim, dstate, **f32) if gl is None
               else gl.clone() for gl in (glastr, glasti)]
        return (du, ddelta, *zero[:4], zero[4], dz, zero[5], *dh0)
    width = dim // ngroups
    tiles = -(-width // 32)
    nchunks = -(-seqlen // checkpoint_steps)
    # partials: dAr, dAi, dD and dbias per (row, block of chunks), dB and
    # dC per 32-channel tile; scratch: each chunk's adjoint and sum of dt
    parts = batch * -(-nchunks // CHUNKS_PER_BLOCK)
    dAr = torch.empty(parts, dim, dstate, **f32)
    dAi = torch.empty_like(dAr)
    dB = torch.empty(tiles, batch, seqlen, ngroups, dstate, **f32)
    dC = torch.empty_like(dB)
    dD = None if D is None else torch.empty(parts, dim, **f32)
    dbias = None if delta_bias is None else torch.empty(parts, dim, **f32)
    dh0r = torch.empty(batch, dim, dstate, **f32)
    dh0i = torch.empty_like(dh0r)
    carryr = torch.empty(batch, nchunks, dim, dstate, **f32)
    carryi = torch.empty_like(carryr)
    dtsum = torch.empty(batch, nchunks, dim, **f32)
    launch(BWD_KERNEL, library(BWD_KERNEL, 9, 28), u.device,
           _DTYPE_CODES[u.dtype], batch, seqlen, dim, dstate, ngroups,
           int(reverse), int(delta_softplus), checkpoint_steps,
           *(ptr(t) for t in (u, delta, z, B, C, Ar, Ai, D, delta_bias,
                              statesr, statesi, g, glastr, glasti, du,
                              ddelta, dz, dAr, dAi, dB, dC, dD, dbias, dh0r,
                              dh0i, carryr, carryi, dtsum)))
    return (du, ddelta, dAr.sum(0), dAi.sum(0),
            dB.sum(0).reshape(B.shape).to(B.dtype),
            dC.sum(0).reshape(C.shape).to(C.dtype),
            None if D is None else dD.sum(0), dz,
            None if delta_bias is None else dbias.sum(0), dh0r, dh0i)


class ComplexChunkedScan(torch.autograd.Function):
    """K7 forward, K8 backward on CUDA tensors (the plain versions on the
    CPU), on the real leaves (u, delta, Ar, Ai, B, C, D, z, delta_bias,
    h0r, h0i): returns (out, lastr, lasti). With ``checkpoint_steps`` > 0
    the forward keeps K7's checkpoints and the backward takes the
    cotangents of all three outputs; the front end passes 0 when no
    backward will follow."""

    @staticmethod
    def forward(ctx, u, delta, Ar, Ai, B, C, D, z, delta_bias, h0r, h0i,
                delta_softplus, reverse, checkpoint_steps):
        ctx.delta_softplus = delta_softplus
        ctx.reverse = reverse
        ctx.checkpoint_steps = checkpoint_steps
        inputs = (u, delta, Ar, Ai, B, C, D, z, delta_bias)
        ctx.on_card = u.device.type == "cuda"
        if not ctx.on_card:
            ctx.save_for_backward(*inputs, h0r, h0i)
            return complex_scan_fwd_ref(*inputs, h0r, h0i, delta_softplus,
                                        reverse)[:3]
        outs = complex_scan_fwd(*inputs, h0r, h0i, delta_softplus, reverse,
                                checkpoint_steps)
        if checkpoint_steps:
            ctx.save_for_backward(*inputs, *outs[3:])
        return outs[:3]

    @staticmethod
    def backward(ctx, g_out, g_lastr, g_lasti):
        if not ctx.on_card:
            *inputs, h0r, h0i = ctx.saved_tensors
            grads = complex_scan_bwd_ref(
                *inputs, h0r, h0i, g_out, g_lastr, g_lasti,
                ctx.delta_softplus, ctx.reverse)
        elif not ctx.checkpoint_steps:
            raise RuntimeError("ComplexChunkedScan ran its forward without "
                               "checkpoints (checkpoint_steps=0), so it has "
                               "no backward")
        else:
            *inputs, statesr, statesi = ctx.saved_tensors
            grads = complex_scan_bwd(
                *inputs, statesr, statesi,
                *(g.contiguous() for g in (g_out, g_lastr, g_lasti)),
                ctx.delta_softplus, ctx.reverse, ctx.checkpoint_steps)
        return tuple(gr if need else None for gr, need in
                     zip(grads, ctx.needs_input_grad)) + (None,) * 3


def complex_scan(u, delta, A, B, C, D=None, z=None, delta_bias=None,
                 delta_softplus=False, initial_state=None, reverse=False,
                 backward=True):
    """``selective_scan`` with complex A on the card: (out, complex64 last
    state) through ``ComplexChunkedScan`` (K7, and K8 in a backward; K7
    writes checkpoints only when ``backward``). The last state is
    assembled from its two channels outside the Function, so its cotangent
    reaches K8 exactly, as in the JAX package."""
    Ar = A.real.float().contiguous()
    Ai = A.imag.float().contiguous()
    if initial_state is None:
        h0r = torch.zeros(u.shape[0], u.shape[2], A.shape[1],
                          dtype=torch.float32, device=u.device)
        h0i = torch.zeros_like(h0r)
    else:
        h = initial_state.to(torch.complex64)
        h0r, h0i = h.real.contiguous(), h.imag.contiguous()
    out, lastr, lasti = ComplexChunkedScan.apply(
        u, delta, Ar, Ai, B, C, D, z, delta_bias, h0r, h0i, delta_softplus,
        reverse, CHECKPOINT_STEPS if backward else 0)
    return out, torch.complex(lastr, lasti)
