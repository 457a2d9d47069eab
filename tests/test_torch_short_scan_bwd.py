"""The backward of the port's short one-direction scan (kernel K6's plain
version, the autograd Function ``ShortScan`` and the front end's route to
it) against the JAX package's, on the CPU.

``jax.vjp`` of ``selective_scan_pallas(..., interpret=True)`` at lengths up
to 64 with no initial state runs the JAX package's ``_short_core``, whose
VJP is ``_short_bwd_kernel`` in Pallas interpret mode; it stops the last
state's gradient, so its cotangent is dropped. The port's
``short_scan_bwd_ref`` and ``ShortScan`` (its launchers replaced by the
plain versions) get the same numpy inputs. An interpret-mode VJP costs
seconds of compiling on the CPU whatever the length, so those cases stay
few; seqlen 1 and 64 are held against the JAX ``impl="ref"`` scan. The CUDA
kernel itself is held against the plain version in
``test_torch_kernels_cuda.py``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_short_scan import (  # noqa: F401 (card_route: a fixture)
    _inputs,
    _np,
    card_route,
    jax_pallas,
)
from video_mamba_suite_tpu.ops import selective_scan as jax_selective_scan
from video_mamba_suite_torch.models import MambaCausal
from video_mamba_suite_torch.ops import (
    ShortScan,
    chunked_scan_bwd_ref,
    selective_scan_ref,
    short_scan_bwd,
    short_scan_bwd_ref,
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


# the modules, which the package's names of the same functions shadow
short = importlib.import_module(
    "video_mamba_suite_torch.ops.selective_scan_short")
mamba_inner = importlib.import_module(
    "video_mamba_suite_torch.ops.mamba_inner")

# each gradient within atol · (its largest magnitude) + rtol · |value| of
# the JAX kernel's. fp32: both walk the same <= 64 steps in fp32 and sum
# dA, dB and dC in other orders; the readings are at most 5.6e-7 of the
# scale, held at about ten times that. bf16: the inputs are the same bf16
# values, both compute in fp32, and each rounds its own fp32 result (du,
# ddelta, dz, dB, dC) once, so a value may sit one bf16 ulp (2^-7 of it)
# away.
TOL = {"float32": (5e-6, 5e-6), "bfloat16": (2e-2, 2e-2)}
ORDER = ("u", "delta", "A", "B", "C", "D", "z", "delta_bias")


def _cotangents(seed, b, l, d, n, dtype):
    rng = np.random.default_rng(seed)
    g = jnp.asarray(rng.standard_normal((b, l, d)), jnp.float32).astype(dtype)
    g_last = jnp.asarray(rng.standard_normal((b, d, n)), jnp.float32)
    return g, g_last


def _jax_vjp(jax_args, g, g_last, **kw):
    """The JAX gradients by input name: ``jax.vjp`` of ``scan`` (with the
    last state) for the cotangents (g, g_last), compiled once."""
    names = list(jax_args)

    def grads(vals, g, g_last):
        _, vjp = jax.vjp(
            lambda *v: jax_selective_scan_fn(**dict(zip(names, v)), **kw),
            *vals)
        return vjp((g, g_last))

    return dict(zip(names, jax.jit(grads)(tuple(jax_args.values()), g,
                                          g_last)))


def jax_selective_scan_fn(impl="pallas", **kw):
    if impl == "pallas":
        return jax_pallas.selective_scan_pallas(**kw, interpret=True)
    return jax_selective_scan(**kw, impl=impl)


def _assert_grads(got, want, dtype, names):
    atol, rtol = TOL[dtype]
    assert len(got) == 8
    for name, gr in zip(ORDER, got):
        if name not in names:
            assert gr is None, name
            continue
        w = _np(want[name])
        assert tuple(gr.shape) == w.shape, name
        np.testing.assert_allclose(_np(gr), w, atol=atol * np.abs(w).max(),
                                   rtol=rtol, err_msg=name)


def _function_grads(args, g, reverse):
    """``ShortScan``'s gradients with K5 and K6 replaced by the plain
    versions, and the calls it made."""
    leaves = {k: v.clone().requires_grad_() for k, v in args.items()}
    full = [leaves.get(k) for k in ORDER]
    calls = []

    def fwd(*a):
        calls.append("fwd")
        return short_scan_fwd_ref(*a)

    def bwd(*a, **k):
        calls.append("bwd")
        return short_scan_bwd_ref(*a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(short, "short_scan_fwd", fwd)
        mp.setattr(short, "short_scan_bwd", bwd)
        out, last = ShortScan.apply(*full, True, reverse)
        assert not last.requires_grad          # the JAX stop_gradient
        found = torch.autograd.grad(out, list(leaves.values()), g)
    assert calls == ["fwd", "bwd"]
    found = dict(zip(leaves, found))
    return tuple(found.get(k) for k in ORDER)


# (seqlen, dtype, D and z, reverse, groups): seqlen 13 and 16; fp32 and
# bf16; with and without D and z; causal and reverse; shared and grouped
# (G = 2) B/C. Each costs about 5 s of compiling on the CPU, so seqlen 1
# and 64 are held against the JAX plain scan below.
CASES = [
    (13, "bfloat16", False, True, 0),
    (16, "float32", True, False, 2),
]


@pytest.mark.parametrize("seqlen,dtype,has_dz,reverse,groups", CASES)
def test_bwd_matches_jax_short_kernel(seqlen, dtype, has_dz, reverse,
                                      groups):
    """The plain K6 and ShortScan's backward against the VJP of the JAX
    short path (``_short_bwd_kernel``) with a nonzero cotangent of the last
    state, which the JAX path drops."""
    batch, dim, dstate = 2, 16, 4
    assert use_short_scan(seqlen)          # the JAX call takes _short_core
    jax_args, args = _inputs(seqlen + groups + 40, batch, seqlen, dim,
                             dstate, groups, dtype, has_dz)
    g, g_last = _cotangents(seqlen, batch, seqlen, dim, dstate, dtype)
    want = _jax_vjp(jax_args, g, g_last, delta_softplus=True,
                    return_last_state=True, reverse=reverse)
    g_t = torch.from_numpy(np.array(g.astype(jnp.float32))).to(
        getattr(torch, dtype))
    got = short_scan_bwd_ref(**args, g=g_t, delta_softplus=True,
                             reverse=reverse)
    _assert_grads(got, want, dtype, args)
    _assert_grads(_function_grads(args, g_t, reverse), want, dtype, args)
    # the dropped cotangent matters: an exact last-state gradient differs
    exact = chunked_scan_bwd_ref(
        **args, g=g_t, g_last=torch.from_numpy(np.array(g_last)),
        delta_softplus=True, reverse=reverse)
    assert not np.allclose(_np(exact[0]), _np(want["u"]), atol=1e-2)


@pytest.mark.parametrize("seqlen,reverse,groups", [(1, True, 2),
                                                   (64, False, 0)])
def test_bwd_matches_jax_ref(seqlen, reverse, groups):
    """seqlen 1 and 64, the shortest and longest short scans, against
    ``jax.vjp`` of the JAX ``selective_scan(impl="ref")`` with a zero
    last-state cotangent."""
    jax_args, args = _inputs(seqlen, 2, seqlen, 16, 8, groups, "float32",
                             True)
    g, g_last = _cotangents(seqlen, 2, seqlen, 16, 8, "float32")
    want = _jax_vjp(jax_args, g, jnp.zeros_like(g_last), impl="ref",
                    delta_softplus=True, return_last_state=True,
                    reverse=reverse)
    got = short_scan_bwd_ref(**args, g=torch.from_numpy(np.array(g)),
                             delta_softplus=True, reverse=reverse)
    _assert_grads(got, want, "float32", args)


@pytest.mark.parametrize("seqlen", [64, 65])
@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("backward", [False, True])
def test_route_rule(card_route, seqlen, h0, backward):
    """The JAX rule, which never looks at the backward: 64 steps (rounded
    up to 8) and no initial state take the short kernels, anything else
    the chunked scan. On the card's branch the short route's last state
    takes no gradient (the JAX stop_gradient); the chunked route's does."""
    _, scan = card_route
    h = torch.zeros(2, 8, 4) if h0 else None
    rule = (jax_pallas._round_up(seqlen, 8) <= jax_pallas.SHORT_SEQ_MAX
            and not h0)
    assert use_short_scan(seqlen, h) == rule
    _, args = _inputs(seqlen, 2, seqlen, 8, 4, 0, "float32", True)
    args["u"].requires_grad_(backward)
    _, last = scan(**args, delta_softplus=True, return_last_state=True,
                   initial_state=h)
    assert last.requires_grad == (backward and not rule)


def _causal_grads(seed):
    model = MambaCausal(d_model=16, d_state=4, expand=2, device="cpu",
                        generator=torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():          # D and the conv bias off their inits
        model.fwd.D.uniform_(-1, 1, generator=g)
        model.fwd.conv_bias.uniform_(-1, 1, generator=g)
    x = torch.randn(2, 40, 16, generator=torch.Generator().manual_seed(1))
    out, (_, last) = model.prefill(x)
    (out ** 2).sum().backward()
    return {n: p.grad for n, p in model.named_parameters()}, last


def test_short_route_gives_every_causal_parameter_a_gradient(card_route):
    """At 40 steps MambaCausal's scan takes ShortScan on the card. With K5
    and K6 replaced by their plain versions, every parameter (in_proj,
    conv, x_proj, dt_proj, dt_bias, A_log, D, out_proj) gets the gradient
    of the CPU's plain autograd, and the last state takes none."""
    calls, _ = card_route
    got, last = _causal_grads(5)
    assert calls == ["short_scan_fwd", "short_scan_bwd"]
    assert not last.requires_grad
    with pytest.MonkeyPatch.context() as mp:   # the plain path
        mp.setattr(mamba_inner, "selective_scan", selective_scan_ref)
        want, want_last = _causal_grads(5)
    assert want_last.requires_grad         # the CPU's state keeps its graph
    assert set(got) == set(want)
    for name, w in want.items():
        gr = got[name]
        assert gr is not None and gr.abs().sum() > 0, name
        torch.testing.assert_close(gr, w, atol=1e-5, rtol=1e-5,
                                   msg=lambda m: f"{name}: {m}")


def test_bwd_wrapper_refuses_cpu_tensors_and_an_initial_state():
    _, args = _inputs(0, 2, 8, 8, 4, 0, "float32", True)
    g = torch.zeros(2, 8, 8)
    with pytest.raises(ValueError, match="launches a CUDA kernel"):
        short_scan_bwd(**args, g=g)
    with pytest.raises(ValueError, match="cotangent"):
        short_scan_bwd(**args)
