"""The backward of the port's fused bidirectional scan (kernel K2's plain
version and the autograd Function around K1 and K2), on the CPU.

``selective_scan_bidir_bwd_ref`` is held against ``jax.vjp`` of
``selective_scan_pallas_bidir`` in Pallas interpret mode, which runs the
JAX package's K2 body. The CUDA kernel itself is held against the plain
version in ``test_torch_kernels_cuda.py``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_selective_scan import _inputs, _np, _to_jax, _to_torch
from video_mamba_suite_tpu.ops.selective_scan_pallas import (
    selective_scan_pallas_bidir,
)
from video_mamba_suite_torch.models import MambaVim
from video_mamba_suite_torch.ops import (
    LAUNCHES,
    selective_scan_bidir_bwd,
    selective_scan_bidir_bwd_ref,
    selective_scan_bidir_ref,
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
mamba_inner = importlib.import_module(
    "video_mamba_suite_torch.ops.mamba_inner")
bidir = importlib.import_module(
    "video_mamba_suite_torch.ops.selective_scan_bidir")

# fp32: the JAX kernel tests' own gradient tolerance
# (tests/test_selective_scan_pallas.py); read at most 1.5e-5 absolute on
# gradients of scale 10 to 80. bf16: the outputs are u's dtype rounded
# from fp32 sums, one to two bf16 ulps apart at most (read: 3.1e-5).
TOL = {"float32": dict(atol=5e-3, rtol=5e-3),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}
ORDER = tuple(n + s for s in "fb"
              for n in ("u", "dt", "A", "B", "C", "D", "z", "bias"))


def _cotangents(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]


@pytest.mark.parametrize("dtype,seqlen,has_dz", [
    ("float32", 13, True),      # 13 takes the JAX kernel's padding to 16
    ("bfloat16", 13, True),
    ("float32", 16, False),
])
def test_bwd_ref_matches_jax_pallas_interpret(dtype, seqlen, has_dz):
    import jax

    arrs = _inputs(seqlen + 5 * has_dz, 3, seqlen, 8, 4)
    if not has_dz:
        for k in ("Df", "Db", "zf", "zb"):
            arrs.pop(k)
    gf, gb = _cotangents(seqlen, (3, seqlen, 8))
    jargs = _to_jax(arrs, dtype)
    names = list(jargs)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32

    def scan(*vals):
        return selective_scan_pallas_bidir(
            **dict(zip(names, vals)), delta_softplus=True, interpret=True)

    _, vjp = jax.vjp(scan, *jargs.values())
    want = dict(zip(names, vjp((jnp.asarray(gf, jdt),
                                jnp.asarray(gb, jdt)))))

    targs = _to_torch(arrs, dtype)
    tdt = getattr(torch, dtype)
    got = selective_scan_bidir_bwd_ref(
        **targs, gf=torch.from_numpy(gf).to(tdt),
        gb=torch.from_numpy(gb).to(tdt))
    assert len(got) == 16
    for name, g in zip(ORDER, got):
        if name not in targs:
            assert g is None, name
            continue
        assert g.dtype == targs[name].dtype, name
        assert g.shape == targs[name].shape, name
        np.testing.assert_allclose(_np(g), _np(want[name]), **TOL[dtype],
                                   err_msg=name)


def test_bwd_wrapper_on_cpu_takes_plain_version():
    t = _to_torch(_inputs(5, 2, 9, 8, 4), "float32")
    gf, gb = (torch.from_numpy(g) for g in _cotangents(1, (2, 9, 8)))
    before = dict(LAUNCHES)
    got = selective_scan_bidir_bwd(**t, gf=gf, gb=gb)
    want = selective_scan_bidir_bwd_ref(**t, gf=gf, gb=gb)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=0, rtol=0)
    assert dict(LAUNCHES) == before


def test_bwd_ref_is_the_vjp_of_the_forward():
    """The plain K2 against torch's own VJP of the plain K1, with zf and zb
    one tensor (as in ViM): each gets its share."""
    t = _to_torch(_inputs(2, 2, 7, 8, 4), "float32")
    t["zb"] = t["zf"]
    gf, gb = (torch.from_numpy(g) for g in _cotangents(3, (2, 7, 8)))
    got = dict(zip(ORDER, selective_scan_bidir_bwd_ref(**t, gf=gf, gb=gb)))
    leaves = {k: v.clone().requires_grad_() for k, v in t.items()
              if k != "zb"}
    outs = selective_scan_bidir_ref(**leaves, zb=leaves["zf"])
    want = dict(zip(leaves, torch.autograd.grad(outs, list(leaves.values()),
                                                (gf, gb))))
    for name, w in want.items():
        g = got[name] + got["zb"] if name == "zf" else got[name]
        torch.testing.assert_close(g, w, atol=1e-6, rtol=1e-6)


@pytest.fixture
def scan_through_function(monkeypatch):
    """Route the mixer's scan through the autograd Function that CUDA
    tensors take, with K1 and K2 replaced by their plain versions so that it
    runs on the CPU. Yields the launches the Function made."""
    calls = {"fwd": 0, "bwd": 0}

    def fwd(*args):
        calls["fwd"] += 1
        with torch.no_grad():
            return selective_scan_bidir_ref(*args)

    def bwd(*args):
        calls["bwd"] += 1
        return selective_scan_bidir_bwd_ref(*args[:16], gf=args[16],
                                            gb=args[17])

    monkeypatch.setattr(bidir, "_launch_fwd", fwd)
    monkeypatch.setattr(bidir, "_launch_bwd", bwd)
    monkeypatch.setattr(mamba_inner, "selective_scan_bidir",
                        lambda *a, **kw: bidir._FusedBidirScan.apply(
                            *a[:10], *(kw[k] for k in bidir.INPUTS[10:])))
    yield calls


def _mixer_grads(seed):
    torch.manual_seed(0)
    model = MambaVim(d_model=16, d_state=4, expand=1, device="cpu",
                     generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():          # D and the conv bias off their inits
        model.fwd.D.uniform_(-1, 1)
        model.bwd.conv_bias.uniform_(-1, 1)
    x = torch.randn(3, 6, 16, generator=torch.Generator().manual_seed(1))
    loss = (model(x) ** 2).sum()
    loss.backward()
    return {n: p.grad for n, p in model.named_parameters()}


def test_scan_function_gives_every_mixer_parameter_a_gradient(
        scan_through_function):
    """The card's path (K1 forward, K2 backward inside an autograd
    Function) against the CPU's plain autograd: every parameter of the
    mixer upstream of the scan (in_proj, conv, x_proj, dt_proj, dt_bias,
    A_log through A = -exp(A_log), D) gets the same gradient. A scan whose
    outputs had no autograd history would leave them all None."""
    got = _mixer_grads(4)
    assert scan_through_function == {"fwd": 1, "bwd": 1}
    with pytest.MonkeyPatch.context() as mp:   # the plain path
        mp.setattr(mamba_inner, "selective_scan_bidir",
                   selective_scan_bidir_ref)
        want = _mixer_grads(4)
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        assert g is not None and g.abs().sum() > 0, name
        torch.testing.assert_close(g, w, atol=1e-6, rtol=1e-5,
                                   msg=lambda m: f"{name}: {m}")
