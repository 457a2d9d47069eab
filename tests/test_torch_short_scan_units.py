"""The algebra of the short one-direction scan's kernels as they walk it
(K5, ``csrc/short_scan_fwd.cu``; K6, ``csrc/short_scan_bwd.cu``), in plain
torch, against the JAX package on the CPU.

K6 walks a row's <= 64 steps as units of 16: a forward pass over every unit
but the last keeps each unit's start state, then the adjoint runs over the
units last first, each walked forward again from its start with its 4-step
pieces' starts kept, then piece by piece (the piece's states recomputed
from its start, the adjoint steps over them), the adjoint dh carried from
one unit into the one before it. K5 walks the units from a zero state,
each step's y summed over the 4 lanes' quarters of the states. Both are
held against ``selective_scan_pallas(..., interpret=True)``, whose short
path is ``_short_core`` (forward ``_short_fwd_kernel``, VJP
``_short_bwd_kernel``, in Pallas interpret mode), and the adjoint also
against ``jax.vjp`` of the JAX plain scan (``impl="ref"``) with a zero
last-state cotangent, as the JAX short path stops that state's gradient.

Compiling the interpret-mode kernels costs the JAX side about 14 s at 37
steps and 25-30 s at 64 on the CPU, so the 64-step case has a file of its
own (``test_torch_short_scan_units_l64.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_short_scan import _inputs, _np, jax_pallas
from test_torch_short_scan_bwd import (
    ORDER,
    _assert_grads,
    _cotangents,
    _jax_vjp,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread runs them faster
    and keeps the test workers beside this file from being
    oversubscribed."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True, scope="module")
def _jax_without_most_optimizations():
    """The JAX references here compile once each for small inputs: XLA's
    optimization passes would cost more CPU than they save, on cores the
    test workers share."""
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


UNIT = 16      # walk steps a unit (kUnitSteps, K6; kUnit, K5)
PIECE = 4      # steps a piece of the adjoint walk (scan_lanes.cuh kPiece)
LANES = 4      # lanes a channel: each sums a quarter of the states
BATCH, DIM, DSTATE = 2, 16, 8
# largest |plain walk - JAX| within atol · (the gradient's largest
# magnitude) + rtol · |value|: fp32 sums in another order over at most 64
# steps, as tests/test_torch_short_scan_bwd.py holds the plain K6 (read at
# most 5.6e-7 of the scale there)
TOL = 5e-6


def _walk_inputs(t, reverse):
    """The per-step quantities in walk order (time reversed when
    ``reverse``): dt = softplus(delta + bias) and its derivative, u, z, g,
    B and C expanded from their groups to the channels, the decays a_t and
    the inputs dt u B."""
    flip = (lambda x: torch.flip(x, dims=(1,))) if reverse else (lambda x: x)
    u, delta, z, g = (flip(t[k]) for k in ("u", "delta", "z", "g"))
    B, C = flip(t["B"]), flip(t["C"])
    dim = u.shape[2]
    if B.dim() == 3:
        B, C = B[:, :, None], C[:, :, None]
    B, C = (x.repeat_interleave(dim // x.shape[2], dim=2) for x in (B, C))
    pre = delta + t["delta_bias"]
    dt = torch.nn.functional.softplus(pre)
    a = torch.exp(dt[..., None] * t["A"])
    return dict(u=u, z=z, g=g, B=B, C=C, dt=dt, sg=torch.sigmoid(pre), a=a,
                dBu=(dt * u)[..., None] * B, flip=flip)


def _units(length):
    return [(s, min(s + UNIT, length)) for s in range(0, length, UNIT)]


def _unit_forward(t, reverse):
    """K5's walk: the units from a zero state, each step's y the sum of the
    lanes' partial sums over their quarters of the states. Returns (out,
    last state)."""
    w = _walk_inputs(t, reverse)
    n = t["A"].shape[1]
    quarters = [slice(q * n // LANES, (q + 1) * n // LANES)
                for q in range(LANES)]
    h = torch.zeros_like(w["a"][:, 0])
    ys = []
    for s0, s1 in _units(w["u"].shape[1]):
        for i in range(s0, s1):
            h = w["a"][:, i] * h + w["dBu"][:, i]
            part = [(w["C"][:, i, :, q] * h[..., q]).sum(-1) for q in quarters]
            ys.append(sum(part) + t["D"] * w["u"][:, i])
    y = torch.stack(ys, 1) * torch.nn.functional.silu(w["z"])
    return w["flip"](y), h


def _unit_adjoint(t, reverse):
    """K6's walk (see the module's note). Returns the gradients in
    ``ORDER``: du, ddelta, dA, dB, dC (in B's and C's group shape), dD, dz,
    ddelta_bias."""
    w = _walk_inputs(t, reverse)
    u, g, a, dBu, dt = w["u"], w["g"], w["a"], w["dBu"], w["dt"]
    s = torch.sigmoid(w["z"])
    silu = w["z"] * s
    gy = g * silu
    dzf = g * (s + silu * (1 - s))
    A, D = t["A"], t["D"]
    units = _units(u.shape[1])

    def step(h, i):
        return a[:, i] * h + dBu[:, i]

    starts = [torch.zeros_like(a[:, 0])]          # the forward pass
    for s0, s1 in units[:-1]:
        h = starts[-1]
        for i in range(s0, s1):
            h = step(h, i)
        starts.append(h)

    du, ddt, dz = (torch.zeros_like(u) for _ in range(3))
    dB, dC = torch.zeros_like(w["B"]), torch.zeros_like(w["C"])
    dA = torch.zeros_like(A)
    dD, dbias = torch.zeros_like(D), torch.zeros_like(D)
    dh = torch.zeros_like(a[:, 0])                 # the adjoint, units last
    for (s0, s1), h in reversed(list(zip(units, starts))):   # first
        pieces = [(p, min(p + PIECE, s1)) for p in range(s0, s1, PIECE)]
        piece_starts = [h]
        for p0, p1 in pieces[:-1]:
            for i in range(p0, p1):
                h = step(h, i)
            piece_starts.append(h)
        for (p0, p1), hp in reversed(list(zip(pieces, piece_starts))):
            states = [hp]
            for i in range(p0, p1):
                states.append(step(states[-1], i))
            for i in reversed(range(p0, p1)):
                h_prev, h_now = states[i - p0], states[i - p0 + 1]
                y = (w["C"][:, i] * h_now).sum(-1) + D * u[:, i]
                dz[:, i] = dzf[:, i] * y
                dh = dh + w["C"][:, i] * gy[:, i, :, None]
                dB[:, i] = dh * (dt[:, i] * u[:, i])[..., None]
                dC[:, i] = gy[:, i, :, None] * h_now
                el = dh * h_prev * a[:, i]
                dA = dA + (el * dt[:, i, :, None]).sum(0)
                s_hb = (dh * w["B"][:, i]).sum(-1)
                ddt[:, i] = ((el * A).sum(-1) + s_hb * u[:, i]) * w["sg"][:, i]
                du[:, i] = s_hb * dt[:, i] + gy[:, i] * D
                dD = dD + (gy[:, i] * u[:, i]).sum(0)
                dbias = dbias + ddt[:, i].sum(0)
                dh = dh * a[:, i]
    shape = t["B"].shape
    groups = shape[2] if len(shape) == 4 else 1

    def per_group(x):      # (b, l, d, n) → the input's (group) shape
        x = x.reshape(*x.shape[:2], groups, -1, x.shape[-1]).sum(3)
        return w["flip"](x.reshape(shape))

    flip = w["flip"]
    return (flip(du), flip(ddt), dA, per_group(dB), per_group(dC), dD,
            flip(dz), dbias)


def _case(seqlen, groups):
    """(JAX arguments, torch arguments with the cotangent ``g``, and the
    cotangents as JAX arrays) at fp32, with D and z."""
    jax_args, args = _inputs(seqlen + 3 * groups + 90, BATCH, seqlen, DIM,
                             DSTATE, groups, "float32", True)
    g, g_last = _cotangents(seqlen + 91, BATCH, seqlen, DIM, DSTATE,
                            "float32")
    return jax_args, dict(args, g=torch.from_numpy(np.array(g))), g, g_last


def assert_close(got, want):
    """``got`` (torch) within TOL of ``want``'s scale and of each value."""
    want = _np(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(_np(got), want, rtol=TOL,
                               atol=TOL * np.abs(want).max())


def test_units_match_jax_short_kernels_l37_reverse_grouped():
    """37 steps, anti-causal, B and C in 2 groups (units of 16, 16 and 5,
    the last with a ragged 4-step piece): K5's units against the output and
    last state of ``_short_fwd_kernel``, K6's against ``jax.vjp`` through
    ``_short_bwd_kernel``, both from one compile."""
    jax_args, args, g, g_last = _case(37, 2)
    names = list(jax_args)

    def scan(*vals):
        return jax_pallas.selective_scan_pallas(
            **dict(zip(names, vals)), delta_softplus=True,
            return_last_state=True, interpret=True, reverse=True)

    def run(vals, g, g_last):
        primal, vjp = jax.vjp(scan, *vals)
        return primal, vjp((g, g_last))

    (out, last), grads = jax.jit(run)(tuple(jax_args.values()), g, g_last)
    for got, want in zip(_unit_forward(args, True), (out, last)):
        assert_close(got, want)
    _assert_grads(_unit_adjoint(args, True), dict(zip(names, grads)),
                  "float32", ORDER)


@pytest.mark.parametrize("seqlen,reverse,groups", [(1, True, 2),
                                                   (17, False, 0)],
                         ids=["l1-reverse-grouped", "l17-causal"])
def test_unit_adjoint_matches_jax_ref(seqlen, reverse, groups):
    """One step (one unit, no forward pass) and 17 (a whole unit and one
    step) against ``jax.vjp`` of the JAX plain scan with a zero last-state
    cotangent."""
    jax_args, args, g, g_last = _case(seqlen, groups)
    want = _jax_vjp(jax_args, g, jnp.zeros_like(g_last), impl="ref",
                    delta_softplus=True, return_last_state=True,
                    reverse=reverse)
    _assert_grads(_unit_adjoint(args, reverse), want, "float32", ORDER)
