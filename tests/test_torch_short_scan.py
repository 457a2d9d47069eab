"""The port's short one-direction scan (kernel K5's plain version and the
front end's route to it) against the JAX package's.

``selective_scan_pallas(..., interpret=True)`` runs the JAX package's K5
body (``_short_fwd_kernel``, reached through ``_short_core``) in Pallas
interpret mode at lengths up to 64 with no initial state; the port's
``short_scan_fwd_ref`` and the CPU ``selective_scan`` get the same numpy
inputs. The CUDA kernel itself is held against the plain version in
``test_torch_kernels_cuda.py``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_mamba_suite_torch.ops import (
    LAUNCHES,
    SHORT_SEQ_MAX,
    chunked_scan_bwd_ref,
    selective_scan,
    selective_scan_ref,
    short_scan_bwd_ref,
    short_scan_fwd,
    short_scan_fwd_ref,
    use_short_scan,
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


# the module (the JAX package's ops names its function the same)
jax_pallas = importlib.import_module(
    "video_mamba_suite_tpu.ops.selective_scan_pallas")
# the port's modules, which the package's names of their functions shadow
short = importlib.import_module(
    "video_mamba_suite_torch.ops.selective_scan_short")
scan_front = importlib.import_module(
    "video_mamba_suite_torch.ops.selective_scan")
chunked = importlib.import_module(
    "video_mamba_suite_torch.ops.selective_scan_chunked")
mamba_inner = importlib.import_module(
    "video_mamba_suite_torch.ops.mamba_inner")

# each output within atol + rtol · |value| of the JAX kernel's. fp32: both
# walk the same steps in fp32. bf16: the inputs are the same bf16 values
# and both compute in fp32, so the output is at most a bf16 ulp or two
# apart (each rounds its own fp32 result) and the fp32 last state is held
# as in fp32.
TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}
STATE_TOL = TOL["float32"]


def _inputs(seed, b, l, d, n, groups, dtype, has_dz):
    rng = np.random.default_rng(seed)
    bc = (b, l, groups, n) if groups else (b, l, n)
    io = dict(
        u=rng.standard_normal((b, l, d)),
        delta=0.5 * rng.random((b, l, d)) - 0.25,
        B=rng.standard_normal(bc), C=rng.standard_normal(bc),
        z=rng.standard_normal((b, l, d)))
    f32 = dict(A=-rng.random((d, n)) - 0.1, D=rng.standard_normal(d),
               delta_bias=0.5 * rng.random(d))
    if not has_dz:
        io.pop("z"), f32.pop("D")
    jax_args = {k: jnp.asarray(v, jnp.float32).astype(dtype)
                for k, v in io.items()}
    jax_args.update({k: jnp.asarray(v, jnp.float32)
                     for k, v in f32.items()})
    torch_dtype = getattr(torch, dtype)
    torch_args = {k: torch.from_numpy(np.array(v.astype(jnp.float32)))
                  .to(torch_dtype if k in io else torch.float32)
                  for k, v in jax_args.items()}
    return jax_args, torch_args


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# seqlen 1, 13, 16 and 64; fp32 and bf16; with and without D and z;
# causal and reverse; shared and grouped (G = 2) B/C
@pytest.mark.parametrize("batch,seqlen,dim,dstate,groups,dtype,has_dz,"
                         "reverse", [
                             (3, 1, 16, 4, 0, "float32", True, False),
                             (2, 13, 24, 4, 0, "bfloat16", False, True),
                             (5, 16, 16, 8, 2, "float32", True, True),
                             (2, 16, 32, 4, 2, "bfloat16", True, False),
                             (2, 64, 16, 16, 0, "float32", True, False),
                         ])
def test_short_scan_matches_jax_short_kernel(batch, seqlen, dim, dstate,
                                             groups, dtype, has_dz, reverse):
    assert use_short_scan(seqlen)          # the JAX call takes _short_core
    jax_args, args = _inputs(seqlen + dim + groups, batch, seqlen, dim,
                             dstate, groups, dtype, has_dz)
    want, want_last = jax_pallas.selective_scan_pallas(
        **jax_args, delta_softplus=True, return_last_state=True,
        interpret=True, reverse=reverse)
    before = dict(LAUNCHES)
    got, got_last = short_scan_fwd_ref(**args, delta_softplus=True,
                                       reverse=reverse)
    front, front_last = selective_scan(**args, delta_softplus=True,
                                       return_last_state=True,
                                       reverse=reverse)
    assert dict(LAUNCHES) == before        # the CPU runs no kernel
    assert got.dtype == getattr(torch, dtype) and got.shape == args[
        "u"].shape
    assert got_last.dtype == torch.float32 and \
        got_last.shape == (batch, dim, dstate)
    for out, last in ((got, got_last), (front, front_last)):
        np.testing.assert_allclose(_np(out), _np(want), **TOL[dtype])
        np.testing.assert_allclose(_np(last), _np(want_last), **STATE_TOL)


def test_short_rule_is_the_jax_rule():
    """The same constant, and lengths rounded up to 8 as the JAX package
    rounds them: 57..64 take the short kernel, 65 does not."""
    assert SHORT_SEQ_MAX == jax_pallas.SHORT_SEQ_MAX
    for seqlen in (1, 13, 57, 64, 65, 72):
        want = jax_pallas._round_up(seqlen, 8) <= jax_pallas.SHORT_SEQ_MAX
        assert use_short_scan(seqlen) == want, seqlen
        assert not use_short_scan(seqlen, torch.zeros(1, 1, 1))


@pytest.fixture
def card_route(monkeypatch):
    """Run ``selective_scan``'s CUDA branch on CPU tensors, the four
    launchers replaced by their plain versions, also for the mixers'
    scans. Yields (the kernels it reached, in order; the scan)."""
    calls = []

    def counted(name, fn):
        def inner(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return inner

    def k3(u, delta, A, B, C, D, z, bias, sp, h0, rev, every):
        out, last = selective_scan_ref(u, delta, A, B, C, D, z, bias, sp,
                                       True, h0, rev)
        if not every:
            return out, last
        return out, last, chunked.chunked_scan_states_ref(
            u, delta, A, B, C, bias, sp, h0, rev, every)

    def k4(u, delta, A, B, C, D, z, bias, h0, states, g, g_last, sp, rev,
           every):
        return chunked_scan_bwd_ref(u, delta, A, B, C, D, z, bias, h0, g,
                                    g_last, sp, rev)

    monkeypatch.setattr(short, "short_scan_fwd",
                        counted("short_scan_fwd", short_scan_fwd_ref))
    monkeypatch.setattr(short, "short_scan_bwd",
                        counted("short_scan_bwd", short_scan_bwd_ref))
    monkeypatch.setattr(chunked, "chunked_scan_fwd",
                        counted("chunked_scan_fwd", k3))
    monkeypatch.setattr(chunked, "chunked_scan_bwd",
                        counted("chunked_scan_bwd", k4))

    def scan(u, delta, A, B, C, D=None, z=None, delta_bias=None,
             delta_softplus=False, return_last_state=False,
             initial_state=None, reverse=False):
        out, last = scan_front._scan_on_card(
            u, delta, A, B, C, D, z, delta_bias, delta_softplus,
            initial_state, reverse)
        return (out, last) if return_last_state else out

    monkeypatch.setattr(mamba_inner, "selective_scan", scan)
    yield calls, scan


# lengths 64 and 65, with and without an initial state, with and without a
# backward to follow: the JAX rule sends 64 steps without an initial state
# to the short kernels (K5, then K6 in the backward) whether or not a
# backward follows, and the rest to the chunked ones (K3, then K4)
@pytest.mark.parametrize("seqlen", [64, 65])
@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("backward", [False, True])
def test_route_on_the_card(card_route, seqlen, h0, backward):
    calls, scan = card_route
    initial_state = torch.zeros(2, 8, 4) if h0 else None
    is_short = seqlen == 64 and not h0
    assert use_short_scan(seqlen, initial_state) == is_short
    _, args = _inputs(seqlen, 2, seqlen, 8, 4, 0, "float32", True)
    args["u"].requires_grad_(backward)
    out = scan(**args, delta_softplus=True, initial_state=initial_state)
    if backward:
        out.sum().backward()
    kernels = ("short_scan_fwd", "short_scan_bwd") if is_short else (
        "chunked_scan_fwd", "chunked_scan_bwd")
    assert calls == list(kernels[:1 + backward])


def test_short_scan_fwd_launches_only_on_cuda():
    _, args = _inputs(0, 2, 8, 8, 4, 0, "float32", True)
    with pytest.raises(ValueError, match="launches a CUDA kernel"):
        short_scan_fwd(**args)
