"""The backward of the port's chunked selective scan (kernel K4's plain
version and the autograd Function around K3 and K4), on the CPU.

``chunked_scan_bwd_ref`` and ``ChunkedScan`` (run with the plain versions
in place of the two launchers) are held against ``jax.vjp`` of
``selective_scan_pallas`` in Pallas interpret mode with cotangents for both
the output and the last state. Batch 5 reaches the JAX package's
``_bwd_kernel``, batch 2 its ``_bwd_kernel_hs``; seqlen 72 > 64 keeps the
JAX call off the short kernel. The same numpy inputs feed both frameworks.
The CUDA kernel itself is held against the plain version in
``test_torch_kernels_cuda.py``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_chunked_scan import _inputs, _jax, _np, _split, _torch
from video_mamba_suite_tpu.ops.selective_scan_pallas import (
    _scan_fwd_impl,
    selective_scan_pallas,
)
from video_mamba_suite_torch.models import MambaScanNorm, MambaVim
from video_mamba_suite_torch.ops import (
    chunked_scan_bwd,
    chunked_scan_bwd_ref,
    chunked_scan_states_ref,
    selective_scan_ref,
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


# the modules, which the package's names of the same functions shadow
chunked = importlib.import_module(
    "video_mamba_suite_torch.ops.selective_scan_chunked")
mamba_inner = importlib.import_module(
    "video_mamba_suite_torch.ops.mamba_inner")

# fp32: each gradient within 1e-4 of its own largest magnitude (and 1e-4
# relative). The two frameworks sum 72-step adjoint chains, dA over batch
# and time, and dB/dC over channels in different orders; the gradients
# reach tens, so a fixed absolute bound would be meaningless.
SCALE_TOL = 1e-4
ORDER = ("u", "delta", "A", "B", "C", "D", "z", "delta_bias",
         "initial_state")


def _cotangents(seed, b, l, d, n):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, l, d)).astype(np.float32),
            rng.standard_normal((b, d, n)).astype(np.float32))


def _jax_grads(arrs, g, g_last, reverse):
    jargs = _jax(arrs)
    names = list(jargs)

    def scan(*vals):
        return selective_scan_pallas(
            **dict(zip(names, vals)), delta_softplus=True,
            return_last_state=True, chunk=8, interpret=True,
            reverse=reverse)

    _, vjp = jax.vjp(scan, *jargs.values())
    return dict(zip(names, vjp((jnp.asarray(g), jnp.asarray(g_last)))))


def _assert_grads(got, want, names):
    assert len(got) == 9
    for name, gr in zip(ORDER, got):
        if name not in names:
            assert gr is None, name
            continue
        w = _np(want[name])
        assert gr.dtype == torch.float32 and gr.shape == w.shape, name
        np.testing.assert_allclose(
            _np(gr), w, atol=SCALE_TOL * np.abs(w).max(), rtol=SCALE_TOL,
            err_msg=name)


def _function_grads(arrs, g, g_last, reverse):
    """The Function's gradients, its launchers replaced by the plain
    versions (the forward's checkpoints by their plain version)."""
    t = {k: v.clone().requires_grad_() for k, v in _torch(arrs).items()}
    full = {k: t.get(k) for k in ORDER}
    calls = []

    def fwd(u, delta, A, B, C, D, z, bias, softplus, h0, rev, every):
        calls.append(("fwd", every))
        out, last = selective_scan_ref(
            u, delta, A, B, C, D=D, z=z, delta_bias=bias,
            delta_softplus=softplus, return_last_state=True,
            initial_state=h0, reverse=rev)
        states = chunked_scan_states_ref(u, delta, A, B, C, bias, softplus,
                                         h0, rev, every)
        return out, last, states

    def bwd(u, delta, A, B, C, D, z, bias, h0, states, g_, g_last_, sp,
            rev, every):
        calls.append(("bwd", tuple(states.shape), g_last_ is not None))
        return chunked_scan_bwd_ref(u, delta, A, B, C, D, z, bias, h0, g_,
                                    g_last_, sp, rev)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(chunked, "chunked_scan_fwd", fwd)
        mp.setattr(chunked, "chunked_scan_bwd", bwd)
        out, last = chunked.ChunkedScan.apply(
            *full.values(), True, reverse, chunked.CHECKPOINT_STEPS)
        leaves = list(t.values())
        found = torch.autograd.grad(
            (out, last), leaves,
            (torch.from_numpy(g), torch.from_numpy(g_last)))
    b, l, d = arrs["u"].shape
    n = arrs["A"].shape[1]
    nchunks = -(-l // chunked.CHECKPOINT_STEPS)
    assert calls == [("fwd", chunked.CHECKPOINT_STEPS),
                     ("bwd", (b, nchunks, d, n), True)]
    found = dict(zip(t, found))
    return tuple(found.get(k) for k in ORDER)


# (batch, reverse, groups, h0, D and z): batch 5 reaches _bwd_kernel (the
# reverse one through flips), batch 2 _bwd_kernel_hs
CASES = [
    (5, False, 0, True, True),
    (5, True, 0, True, True),
    (2, False, 0, True, True),
    (2, True, 0, False, True),
    (5, False, 2, False, True),
    (2, True, 2, True, False),
]


@pytest.mark.parametrize("batch,reverse,groups,h0,has_dz", CASES)
def test_bwd_matches_jax_pallas_interpret(batch, reverse, groups, h0,
                                          has_dz):
    """The plain K4 and the Function's backward, each against the VJP of
    the JAX package's chunked scan, with a nonzero last-state cotangent:
    all nine gradients, dh0 included."""
    arrs = _split(_inputs(batch + 3 * groups + reverse, batch, 72, 16, 4,
                          groups), has_dz, h0)
    g, g_last = _cotangents(batch + reverse, batch, 72, 16, 4)
    want = _jax_grads(arrs, g, g_last, reverse)
    got = chunked_scan_bwd_ref(
        **_torch(arrs), g=torch.from_numpy(g),
        g_last=torch.from_numpy(g_last), delta_softplus=True,
        reverse=reverse)
    _assert_grads(got, want, arrs)
    _assert_grads(_function_grads(arrs, g, g_last, reverse), want, arrs)


@pytest.mark.parametrize("reverse", [False, True])
def test_checkpoints_match_jax_want_states(reverse):
    """The plain version of K3's checkpoints is the JAX forward's
    ``want_states`` output (the state before each chunk) at the same
    interval; JAX keeps them in time-chunk order, the port in walk
    order."""
    arrs = _inputs(9, 5, 72, 16, 4)
    j = _jax(arrs)
    _, states, _ = _scan_fwd_impl(
        j["u"], j["delta"], j["A"], j["B"][:, :, None], j["C"][:, :, None],
        j["D"], j["z"], j["delta_bias"], j["initial_state"], True, 8, 256,
        True, want_states=True, reverse=reverse)
    want = np.swapaxes(np.asarray(states)[:5, :, :, :16], 2, 3)
    if reverse:
        want = want[:, ::-1]
    t = _torch(arrs)
    got = chunked_scan_states_ref(t["u"], t["delta"], t["A"], t["B"],
                                  t["C"], t["delta_bias"], True,
                                  t["initial_state"], reverse, 8)
    assert got.shape == (5, 9, 16, 4)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


def test_bwd_ref_without_cotangent_of_the_last_state():
    """g_last None is a zero cotangent: dh0 is then a_first · dh_first,
    and dropping the last state's term changes the other gradients."""
    arrs = _inputs(4, 2, 20, 8, 4)
    g, g_last = _cotangents(4, 2, 20, 8, 4)
    t = _torch(arrs)
    plain = chunked_scan_bwd_ref(**t, g=torch.from_numpy(g),
                                 delta_softplus=True)
    zero = chunked_scan_bwd_ref(**t, g=torch.from_numpy(g),
                                g_last=torch.zeros(2, 8, 4),
                                delta_softplus=True)
    full = chunked_scan_bwd_ref(**t, g=torch.from_numpy(g),
                                g_last=torch.from_numpy(g_last),
                                delta_softplus=True)
    for p, zr, f in zip(plain, zero, full):
        torch.testing.assert_close(p, zr, atol=0, rtol=0)
    assert not torch.allclose(plain[8], full[8])
    assert not torch.allclose(plain[2], full[2])


def test_function_without_checkpoints_has_no_backward():
    t = _torch(_split(_inputs(2, 2, 9, 8, 4), h0=False))
    u = t["u"].requires_grad_()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(chunked, "chunked_scan_fwd",
                   lambda u, delta, A, B, C, D, z, bias, sp, h0, rev, every:
                   selective_scan_ref(u, delta, A, B, C, D, z, bias, sp,
                                      True, h0, rev))
        out, _ = chunked.ChunkedScan.apply(
            u, t["delta"], t["A"], t["B"], t["C"], t["D"], t["z"],
            t["delta_bias"], None, True, False, 0)
        with pytest.raises(RuntimeError, match="without checkpoints"):
            out.sum().backward()


def test_bwd_wrapper_refuses_bad_intervals_and_cpu_tensors():
    t = _torch(_inputs(5, 2, 9, 8, 4))
    g = torch.zeros(2, 9, 8)
    for every in (0, 6, 68):
        with pytest.raises(ValueError, match="checkpoint_steps"):
            chunked_scan_bwd(**t, states=torch.zeros(2, 1, 8, 4), g=g,
                             checkpoint_steps=every)
    with pytest.raises(ValueError, match="CUDA kernel"):
        chunked_scan_bwd(**t, states=torch.zeros(2, 1, 8, 4), g=g)


@pytest.fixture
def scan_through_function(monkeypatch):
    """Route the mixers' one-direction scans through ChunkedScan, the path
    CUDA tensors take, with K3 and K4 replaced by their plain versions so
    that it runs on the CPU. Yields the launches the Function made."""
    calls = {"fwd": 0, "bwd": 0}

    def fwd(u, delta, A, B, C, D, z, bias, sp, h0, rev, every):
        calls["fwd"] += 1
        out, last = selective_scan_ref(u, delta, A, B, C, D, z, bias, sp,
                                       True, h0, rev)
        return out, last, chunked_scan_states_ref(u, delta, A, B, C, bias,
                                                  sp, h0, rev, every)

    def bwd(u, delta, A, B, C, D, z, bias, h0, states, g, g_last, sp, rev,
            every):
        calls["bwd"] += 1
        return chunked_scan_bwd_ref(u, delta, A, B, C, D, z, bias, h0, g,
                                    g_last, sp, rev)

    def scan(u, delta, A, B, C, D=None, z=None, delta_bias=None,
             delta_softplus=False, return_last_state=False,
             initial_state=None, reverse=False):
        out, last = chunked.ChunkedScan.apply(
            u, delta, A, B, C, D, z, delta_bias, initial_state,
            delta_softplus, reverse, chunked.CHECKPOINT_STEPS)
        return (out, last) if return_last_state else out

    monkeypatch.setattr(chunked, "chunked_scan_fwd", fwd)
    monkeypatch.setattr(chunked, "chunked_scan_bwd", bwd)
    monkeypatch.setattr(mamba_inner, "selective_scan", scan)
    yield calls


def _mixer_grads(cls, seed):
    torch.manual_seed(0)
    model = cls(d_model=16, d_state=4, expand=1, device="cpu",
                generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():          # D and the conv bias off their inits
        model.fwd.D.uniform_(-1, 1)
        model.bwd.conv_bias.uniform_(-1, 1)
    x = torch.randn(2, 70, 16, generator=torch.Generator().manual_seed(1))
    (model(x) ** 2).sum().backward()
    return {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("cls", [MambaVim, MambaScanNorm])
def test_long_route_gives_every_mixer_parameter_a_gradient(
        scan_through_function, cls):
    """At seqlen 70 > 64 each direction is one chunked scan. Through the
    card's path (K3 forward, K4 backward inside ChunkedScan) every
    parameter (in_proj, conv, x_proj, dt_proj, dt_bias, A_log, D,
    out_proj and scan_norm_w) gets the gradient of the CPU's plain
    autograd."""
    got = _mixer_grads(cls, 4)
    assert scan_through_function == {"fwd": 2, "bwd": 2}
    with pytest.MonkeyPatch.context() as mp:   # the plain path
        mp.setattr(mamba_inner, "selective_scan", selective_scan_ref)
        want = _mixer_grads(cls, 4)
    assert set(got) == set(want)
    if cls is MambaScanNorm:
        assert "scan_norm_w" in got
    for name, w in want.items():
        gr = got[name]
        assert gr is not None and gr.abs().sum() > 0, name
        torch.testing.assert_close(gr, w, atol=1e-5, rtol=1e-5,
                                   msg=lambda m: f"{name}: {m}")
