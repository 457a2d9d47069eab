"""The port's complex-A selective scan (K7/K8: ``complex_scan_fwd_ref``,
``complex_scan_bwd_ref``, the autograd Function ``ComplexChunkedScan`` and
``selective_scan_ref`` with complex A) against the JAX package on the CPU:
the same numpy arrays (A as Ar + i·Ai, the initial state likewise) through
JAX's ``selective_scan_ref`` and through ``selective_scan_pallas`` with its
complex Pallas kernels in interpret mode (forward and ``jax.vjp``)."""

import functools
import importlib

import jax
import numpy as np
import pytest
import torch

from video_mamba_suite_torch.ops import (
    ComplexChunkedScan,
    complex_scan_bwd,
    complex_scan_bwd_ref,
    complex_scan_fwd,
    complex_scan_fwd_ref,
    selective_scan,
    selective_scan_ref,
)
from video_mamba_suite_tpu.ops.selective_scan import (
    selective_scan_ref as jax_selective_scan_ref,
)
from video_mamba_suite_tpu.ops.selective_scan_pallas import (
    _complex_fwd_impl,
    selective_scan_pallas,
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


# the module, which the package's name of its function shadows
scan_module = importlib.import_module(
    "video_mamba_suite_torch.ops.selective_scan")

# largest |port - JAX| over each output's largest magnitude (at least 1):
# fp32 sums and transcendentals in another order, read at most 4.7e-7
# (the gradients); held at 1e-5, tighter than the JAX package's own
# complex-path tests (2e-4 to 3e-3 absolute)
TOL = 1e-5
b, l, d, n = 2, 24, 16, 4
CHUNK = 8      # the JAX kernels' chunk: interpret mode unrolls it


def _case(groups, seed):
    """Numpy inputs of one case: grouped (groups > 0) or shared B/C, with
    D, z, bias, an initial state and cotangents of the output and of the
    last state's two channels."""
    rng = np.random.default_rng(seed)
    f = np.float32
    bc = (b, l, groups, n) if groups else (b, l, n)
    return dict(
        u=rng.standard_normal((b, l, d)).astype(f),
        delta=(0.5 * rng.random((b, l, d))).astype(f),
        Ar=(-0.5 * rng.random((d, n))).astype(f),
        Ai=rng.standard_normal((d, n)).astype(f),
        B=rng.standard_normal(bc).astype(f),
        C=rng.standard_normal(bc).astype(f),
        D=rng.standard_normal(d).astype(f),
        z=rng.standard_normal((b, l, d)).astype(f),
        delta_bias=(0.5 * rng.random(d)).astype(f),
        h0r=rng.standard_normal((b, d, n)).astype(f),
        h0i=rng.standard_normal((b, d, n)).astype(f),
        g=rng.standard_normal((b, l, d)).astype(f),
        glastr=rng.standard_normal((b, d, n)).astype(f),
        glasti=rng.standard_normal((b, d, n)).astype(f),
    )


LEAVES = ("u", "delta", "Ar", "Ai", "B", "C", "D", "z", "delta_bias", "h0r",
          "h0i")


@functools.lru_cache(maxsize=None)
def _jax_pallas(reverse, groups):
    """``selective_scan_pallas`` with complex A (its Pallas kernels in
    interpret mode) on a case: (out, last state, gradients at the real
    leaves in ``LEAVES`` order) as numpy."""
    c = _case(groups, 3 + groups + int(reverse))

    def scan(u, delta, Ar, Ai, B, C, D, z, delta_bias, h0r, h0i):
        out, last = selective_scan_pallas(
            u, delta, Ar + 1j * Ai, B, C, D=D, z=z, delta_bias=delta_bias,
            delta_softplus=True, return_last_state=True, chunk=CHUNK,
            interpret=True, initial_state=h0r + 1j * h0i, reverse=reverse)
        return out, last.real, last.imag

    (out, lr, li), vjp = jax.vjp(scan, *(c[k] for k in LEAVES))
    grads = vjp((c["g"], c["glastr"], c["glasti"]))
    return (np.asarray(out), np.asarray(lr) + 1j * np.asarray(li),
            tuple(np.asarray(x) for x in grads))


def _torch(c, keys=LEAVES):
    return {k: torch.from_numpy(c[k]) for k in keys}


def _close(got, want):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= TOL * scale


# (reverse, groups): each costs the JAX side seconds of interpret mode
PALLAS_CASES = [(False, 2), (True, 0)]
PALLAS_IDS = ["causal-grouped", "reverse-shared"]


@pytest.mark.parametrize("reverse,groups", PALLAS_CASES, ids=PALLAS_IDS)
def test_complex_scan_fwd_ref_matches_jax_kernel(reverse, groups):
    """Output and complex last state, with an initial state, causal or
    reverse, shared or grouped B/C; checkpoints are the states at the
    segment starts."""
    want_out, want_last, _ = _jax_pallas(reverse, groups)
    c = _case(groups, 3 + groups + int(reverse))
    t = _torch(c)
    out, lr, li, sr, si = complex_scan_fwd_ref(
        **t, delta_softplus=True, reverse=reverse, checkpoint_steps=CHUNK)
    _close(out, want_out)
    _close(torch.complex(lr, li).numpy(), want_last)
    assert sr.shape == si.shape == (b, l // CHUNK, d, n)
    assert torch.equal(sr[:, 0], t["h0r"]) and torch.equal(si[:, 0], t["h0i"])
    flip = (lambda x: torch.flip(x, dims=(1,))) if reverse else (lambda x: x)
    for j in range(1, l // CHUNK):      # the state before walk step j·S
        sl = slice(0, j * CHUNK)
        _, last = selective_scan_ref(
            *(flip(t[k])[:, sl] for k in ("u", "delta")),
            torch.complex(t["Ar"], t["Ai"]),
            *(flip(t[k])[:, sl] for k in ("B", "C")),
            delta_bias=t["delta_bias"], delta_softplus=True,
            return_last_state=True,
            initial_state=torch.complex(t["h0r"], t["h0i"]))
        assert torch.allclose(torch.complex(sr[:, j], si[:, j]), last,
                              atol=1e-6)


@pytest.mark.parametrize("bc", ["shared", "grouped", "complex"])
def test_selective_scan_ref_complex_matches_jax_ref(bc):
    """``selective_scan_ref`` with complex A against the JAX
    ``selective_scan_ref`` (no initial state there): real B/C shared by
    all channels or grouped, and complex B/C, which the JAX reference takes
    too."""
    c = _case(2 if bc == "grouped" else 0, 11)
    A = c["Ar"] + 1j * c["Ai"]
    B, C = c["B"], c["C"]
    if bc == "complex":
        rng = np.random.default_rng(12)
        B = (B + 1j * rng.standard_normal(B.shape)).astype(np.complex64)
        C = (C + 1j * rng.standard_normal(C.shape)).astype(np.complex64)
    kw = dict(delta_softplus=True, return_last_state=True)
    want_out, want_last = jax_selective_scan_ref(
        c["u"], c["delta"], A.astype(np.complex64), B, C, D=c["D"],
        z=c["z"], delta_bias=c["delta_bias"], **kw)
    t = _torch(c, ("u", "delta", "D", "z", "delta_bias"))
    out, last = selective_scan_ref(
        t["u"], t["delta"], torch.from_numpy(A.astype(np.complex64)),
        torch.from_numpy(B), torch.from_numpy(C), D=t["D"], z=t["z"],
        delta_bias=t["delta_bias"], **kw)
    assert out.dtype == torch.float32 and last.dtype == torch.complex64
    _close(out, np.asarray(want_out))
    _close(last.numpy(), np.asarray(want_last))


@pytest.mark.parametrize("reverse,groups", PALLAS_CASES, ids=PALLAS_IDS)
def test_complex_scan_bwd_ref_matches_jax_vjp(reverse, groups):
    """The plain K8 against ``jax.vjp`` of the Pallas complex path, with
    cotangents of the output and of both last-state channels, compared at
    the real leaves (Ar, Ai, h0r, h0i too: PyTorch's gradient of a complex
    leaf is the conjugate of JAX's, so no complex leaf is compared)."""
    *_, want = _jax_pallas(reverse, groups)
    c = _case(groups, 3 + groups + int(reverse))
    got = complex_scan_bwd_ref(
        **_torch(c), **_torch(c, ("g", "glastr", "glasti")),
        delta_softplus=True, reverse=reverse)
    for name, gr, w in zip(LEAVES, got, want):
        assert gr.dtype == torch.float32, name
        _close(gr, w)


def test_complex_chunked_scan_function_on_cpu():
    """``ComplexChunkedScan`` on its CPU route: the plain forward, and a
    backward through ``complex_scan_bwd_ref`` that equals autograd through
    ``selective_scan_ref`` with a complex A leaf, whose gradient is dAr +
    i·dAi (PyTorch's convention)."""
    c = _case(2, 21)
    t = {k: v.requires_grad_() for k, v in _torch(c).items()}
    out, lr, li = ComplexChunkedScan.apply(
        *(t[k] for k in LEAVES), True, False, 0)
    g = _torch(c, ("g", "glastr", "glasti"))
    torch.autograd.backward((out, lr, li), (g["g"], g["glastr"],
                                            g["glasti"]))
    A = torch.complex(*(torch.from_numpy(c[k]) for k in ("Ar", "Ai")))
    h0 = torch.complex(*(torch.from_numpy(c[k]) for k in ("h0r", "h0i")))
    leaves = {k: torch.from_numpy(c[k]).requires_grad_()
              for k in ("u", "delta", "B", "C", "D", "z", "delta_bias")}
    A.requires_grad_()
    h0.requires_grad_()
    want, last = selective_scan_ref(
        leaves["u"], leaves["delta"], A, leaves["B"], leaves["C"],
        D=leaves["D"], z=leaves["z"], delta_bias=leaves["delta_bias"],
        delta_softplus=True, return_last_state=True, initial_state=h0)
    assert torch.allclose(out, want, atol=1e-6)
    assert torch.allclose(torch.complex(lr, li), last, atol=1e-6)
    glast = torch.complex(g["glastr"], g["glasti"])
    loss = (want * g["g"]).sum() + (last * glast.conj()).real.sum()
    loss.backward()
    for k, leaf in leaves.items():
        assert torch.allclose(t[k].grad, leaf.grad, atol=1e-5), k
    for part, grad in (("r", lambda x: x.real), ("i", lambda x: x.imag)):
        assert torch.allclose(t["A" + part].grad, grad(A.grad), atol=1e-4)
        assert torch.allclose(t["h0" + part].grad, grad(h0.grad), atol=1e-5)


def test_selective_scan_routes_complex_a(monkeypatch):
    """On the CPU ``selective_scan`` with complex A is the plain version.
    The card's branch (``_scan_on_card``, here with the Function's CPU
    route) sends complex A to ``complex_scan`` before any length rule,
    with or without an initial state, and real A never."""
    c = _case(0, 31)
    t = _torch(c)
    A = torch.complex(t["Ar"], t["Ai"])
    h0 = torch.complex(t["h0r"], t["h0i"])
    want = selective_scan_ref(t["u"], t["delta"], A, t["B"], t["C"],
                              return_last_state=True, initial_state=h0)
    got = selective_scan(t["u"], t["delta"], A, t["B"], t["C"],
                         return_last_state=True, initial_state=h0)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])

    calls = []
    route = scan_module.complex_scan.complex_scan
    monkeypatch.setattr(scan_module.complex_scan, "complex_scan",
                        lambda *a: calls.append(a[-1]) or route(*a))
    for h in (None, h0):
        out, last = scan_module._scan_on_card(
            t["u"], t["delta"], A, t["B"], t["C"], None, None, None, False,
            h, False)
        want = selective_scan_ref(t["u"], t["delta"], A, t["B"], t["C"],
                                  return_last_state=True, initial_state=h)
        assert torch.allclose(out, want[0], atol=1e-6)
        assert torch.allclose(last, want[1], atol=1e-6)
    assert calls == [False, False]      # no input needs a gradient
    with pytest.raises(ValueError, match="launches a CUDA kernel"):
        scan_module._scan_on_card(t["u"], t["delta"], t["Ar"], t["B"],
                                  t["C"], None, None, None, False, None,
                                  False)
    assert len(calls) == 2


def test_kernel_wrappers_refuse_cpu_tensors():
    t = _torch(_case(0, 41))
    args = [t[k] for k in ("u", "delta", "Ar", "Ai", "B", "C")]
    with pytest.raises(ValueError, match="launches a CUDA kernel"):
        complex_scan_fwd(*args)
    with pytest.raises(ValueError, match="launches a CUDA kernel"):
        complex_scan_bwd(*args, statesr=t["h0r"][:, None],
                         statesi=t["h0i"][:, None], g=t["u"])


# ---------------------------------------------------------------------------
# The algebra of K7's split and K8's chunked adjoint, in plain torch, held
# against the JAX package's complex Pallas kernels (interpret mode)


def _walk_inputs(t, reverse):
    """(dt, u, B, C per channel in walk order, A, dt_pre): the scan's
    per-step quantities as the kernels walk them (softplus applied, B and C
    expanded from their groups to the channels)."""
    flip = (lambda x: torch.flip(x, dims=(1,))) if reverse else (lambda x: x)
    u, delta, z = (flip(t[k]) for k in ("u", "delta", "z"))
    B, C = flip(t["B"]), flip(t["C"])
    dim = u.shape[2]
    if B.dim() == 3:
        B, C = B[:, :, None], C[:, :, None]
    B, C = (x.repeat_interleave(dim // x.shape[2], dim=2) for x in (B, C))
    pre = delta + t["delta_bias"]
    dt = torch.nn.functional.softplus(pre)
    A = torch.complex(t["Ar"], t["Ai"])
    return dt, u, z, B, C, A, pre


def _split_fwd(t, seglen, reverse, chunk=CHUNK):
    """K7's split in plain torch: pass 1 walks every segment from zero
    (end state and sum of dt), the combine chains the end states from the
    initial state by exp(A·Σdt) (complex), pass 2 walks each segment again
    from its start. Returns (out, complex last state, checkpoints: the
    state before every ``chunk``-th walk step, taken in pass 2)."""
    dt, u, z, B, C, A, _ = _walk_inputs(t, reverse)
    length = u.shape[1]
    dA = dt[..., None] * A                       # (b, l, d, n) complex
    dBu = (dt * u)[..., None] * B
    bounds = [(s, min(s + seglen, length)) for s in range(0, length, seglen)]
    ends, sums = [], []
    for s0, s1 in bounds:                         # pass 1
        h = torch.zeros_like(dA[:, 0])
        for i in range(s0, s1):
            h = torch.exp(dA[:, i]) * h + dBu[:, i]
        ends.append(h)
        sums.append(dt[:, s0:s1].sum(1))
    h = torch.complex(t["h0r"], t["h0i"])          # combine
    starts = []
    for e, total in zip(ends, sums):
        starts.append(h)
        h = torch.exp(total[..., None] * A) * h + e
    ys, states = [], []                             # pass 2
    for (s0, s1), h in zip(bounds, starts):
        for i in range(s0, s1):
            if i % chunk == 0:
                states.append(h)
            h = torch.exp(dA[:, i]) * h + dBu[:, i]
            ys.append(2 * (C[:, i] * h.real).sum(-1))
    y = (torch.stack(ys, 1) + t["D"] * u) * torch.nn.functional.silu(z)
    out = torch.flip(y, dims=(1,)) if reverse else y
    return out, h, torch.stack(states, 1)


# segment lengths at 24 steps: 2 segments, 4 segments, a ragged last one
SEGMENTS = [12, 6, 10]


@pytest.mark.parametrize("seglen", SEGMENTS, ids=["2seg", "4seg", "ragged"])
@pytest.mark.parametrize("reverse,groups", PALLAS_CASES, ids=PALLAS_IDS)
def test_split_forward_matches_jax_kernel(reverse, groups, seglen):
    """K7's split (segments from zero, end states chained by exp(A·Σdt))
    against the Pallas kernel's output and last state, causal with grouped
    B/C or reverse with shared B/C, both from an initial state, within TOL
    of each output's scale (read at most 6.7e-7); its checkpoints equal
    the plain version's, which the first test holds against the JAX
    reference (1e-6)."""
    want_out, want_last, _ = _jax_pallas(reverse, groups)
    c = _case(groups, 3 + groups + int(reverse))
    t = _torch(c)
    out, last, states = _split_fwd(t, seglen, reverse)
    _close(out, want_out)
    _close(last.numpy(), want_last)
    _, _, _, sr, si = complex_scan_fwd_ref(
        **t, delta_softplus=True, reverse=reverse, checkpoint_steps=CHUNK)
    assert torch.allclose(states, torch.complex(sr, si), atol=1e-6)


def test_split_forward_at_hundreds_of_radians():
    """Two segments of 32 steps whose Σdt·Ai runs to hundreds of radians
    (213 at most; Ai 3 times a normal draw, as the card's cases draw it, so
    a step turns at most some 12 radians; Ar near 0, so the carried state
    stays large; B and C shared, one group, which ``_complex_fwd_impl``
    takes unpadded): the split's output, last state and checkpoints
    against ``_complex_fwd_impl`` in interpret mode, within TOL of each
    output's scale (read at most 7.6e-7: float32 rounds the segment's Σdt
    and each step's angle differently)."""
    rng = np.random.default_rng(51)
    f = np.float32
    steps, seglen = 64, 32
    c = {k: v for k, v in _case(2, 51).items()
         if k in ("D", "delta_bias", "h0r", "h0i")}
    c.update(
        u=rng.standard_normal((b, steps, d)).astype(f),
        delta=(0.5 * rng.random((b, steps, d))).astype(f),
        z=rng.standard_normal((b, steps, d)).astype(f),
        B=rng.standard_normal((b, steps, 1, n)).astype(f),
        C=rng.standard_normal((b, steps, 1, n)).astype(f),
        Ar=(-0.05 * rng.random((d, n))).astype(f),
        Ai=(3.0 * rng.standard_normal((d, n))).astype(f))
    t = _torch(c)
    out, last, states = _split_fwd(t, seglen, False)
    dt = torch.nn.functional.softplus(t["delta"] + t["delta_bias"])
    angles = dt[:, :seglen].sum(1)[..., None] * t["Ai"].abs()
    assert angles.max() > 200          # the combine's rotation is large
    want = _complex_fwd_impl(
        c["u"], c["delta"], c["Ar"], c["Ai"], c["B"], c["C"], c["D"],
        c["z"], c["delta_bias"], c["h0r"], c["h0i"], True, CHUNK, 128, True,
        want_states=True)
    want_out, wsr, wsi, wlr, wli = (np.asarray(x) for x in want)
    wst = (np.swapaxes(wsr, 2, 3) + 1j * np.swapaxes(wsi, 2, 3))[:b, :, :d]

    _close(out, want_out)
    _close(last.numpy(), wlr + 1j * wli)
    _close(states.numpy(), wst)


def _chunked_adjoint(t, g, glastr, glasti, chunk, reverse):
    """K8's algorithm in plain torch: the local pass walks each chunk back
    from a zero adjoint (dh += 2·C·gy, then dh ← conj(a_t)·dh), the
    combine chains the chunks from the walk's end by conj(exp(A·Σdt)) from
    the last state's cotangent, and the main pass walks each chunk back
    again from its checkpoint's states with that exact incoming adjoint,
    writing every gradient. Returns the gradients in ``LEAVES`` order."""
    dt, u, z, B, C, A, pre = _walk_inputs(t, reverse)
    flip = (lambda x: torch.flip(x, dims=(1,))) if reverse else (lambda x: x)
    g = flip(g)
    sg = torch.sigmoid(z)
    silu = z * sg
    gy = g * silu
    dA = dt[..., None] * A
    a = torch.exp(dA)                             # (b, l, d, n) complex
    dBu = (dt * u)[..., None] * B
    length = u.shape[1]
    bounds = [(s, min(s + chunk, length)) for s in range(0, length, chunk)]

    def back_step(dh, i):
        return torch.conj(a[:, i]) * (dh + 2 * C[:, i] * gy[:, i, :, None])

    local = []                                   # the local pass
    for s0, s1 in bounds:
        dh = torch.zeros_like(a[:, 0])
        for i in reversed(range(s0, s1)):
            dh = back_step(dh, i)
        local.append((dh, dt[:, s0:s1].sum(1)))
    m = torch.complex(glastr, glasti)              # the combine
    incoming = [None] * len(bounds)
    for j in reversed(range(len(bounds))):
        incoming[j] = m
        e, total = local[j]
        m = torch.conj(torch.exp(total[..., None] * A)) * m + e
    dh0 = m
    h = torch.complex(t["h0r"], t["h0i"])         # the checkpoints
    checkpoints = []
    for s0, s1 in bounds:
        checkpoints.append(h)
        for i in range(s0, s1):
            h = a[:, i] * h + dBu[:, i]
    du, ddt, dz = (torch.zeros_like(u) for _ in range(3))
    dB, dC = torch.zeros_like(B), torch.zeros_like(C)
    dAc = torch.zeros_like(a[:, 0])              # dAr + i·dAi per row
    for (s0, s1), hs, dh in zip(bounds, checkpoints, incoming):   # main
        states = [hs]
        for i in range(s0, s1):
            states.append(a[:, i] * states[-1] + dBu[:, i])
        for i in reversed(range(s0, s1)):
            h_prev, h_now = states[i - s0], states[i - s0 + 1]
            y = 2 * (C[:, i] * h_now.real).sum(-1) + t["D"] * u[:, i]
            dz[:, i] = g[:, i] * y * (sg[:, i] + silu[:, i] * (1 - sg[:, i]))
            dh = dh + 2 * C[:, i] * gy[:, i, :, None]
            w = dh * torch.conj(h_prev) * torch.conj(a[:, i])
            dAc = dAc + dt[:, i, :, None] * w
            s_hb = (dh.real * B[:, i]).sum(-1)
            ddt[:, i] = ((A.real * w.real + A.imag * w.imag).sum(-1)
                         + u[:, i] * s_hb)
            du[:, i] = dt[:, i] * s_hb + gy[:, i] * t["D"]
            dB[:, i] = dh.real * (dt[:, i] * u[:, i])[..., None]
            dC[:, i] = 2 * gy[:, i, :, None] * h_now.real
            dh = torch.conj(a[:, i]) * dh
    ddelta = ddt * torch.sigmoid(pre)
    groups = t["B"].shape[2] if t["B"].dim() == 4 else 1

    def per_group(x):      # (b, l, d, n) → the input's (group) shape
        x = x.reshape(*x.shape[:2], groups, -1, x.shape[-1]).sum(3)
        return flip(x.reshape(t["B"].shape))

    return (flip(du), flip(ddelta), dAc.real.sum(0), dAc.imag.sum(0),
            per_group(dB), per_group(dC), (gy * u).sum((0, 1)), flip(dz),
            ddelta.sum((0, 1)), dh0.real, dh0.imag)


@pytest.mark.parametrize("chunk", [CHUNK, 5], ids=["chunk8", "chunk5"])
@pytest.mark.parametrize("reverse,groups", PALLAS_CASES, ids=PALLAS_IDS)
def test_chunked_adjoint_matches_jax_vjp(reverse, groups, chunk):
    """K8's local pass, conj(a_chunk) combine and main pass in plain torch
    against ``jax.vjp`` of the Pallas complex path (``_complex_core_bwd``'s
    kernel), with cotangents of the output and of both last-state
    channels, at every real leaf; chunks of 8 steps (3) and of 5 (a ragged
    last chunk); within TOL of each gradient's scale (read at most
    6.4e-7)."""
    *_, want = _jax_pallas(reverse, groups)
    c = _case(groups, 3 + groups + int(reverse))
    cot = _torch(c, ("g", "glastr", "glasti"))
    got = _chunked_adjoint(_torch(c), cot["g"], cot["glastr"],
                           cot["glasti"], chunk, reverse)
    for name, gr, w in zip(LEAVES, got, want):
        _close(gr, w)
