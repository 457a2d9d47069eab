"""The port's selective scans against the JAX package's.

The plain versions run here on the CPU: ``selective_scan_ref`` against the
JAX ``selective_scan_ref``, and ``selective_scan_bidir_ref`` (the plain
version of kernel K1) against ``selective_scan_pallas_bidir`` in Pallas
interpret mode. The same numpy inputs feed both frameworks. The CUDA kernel
itself is held against the plain version in ``test_torch_kernels_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_mamba_suite_tpu.ops import selective_scan_ref as jax_scan_ref
from video_mamba_suite_tpu.ops.selective_scan_pallas import (
    selective_scan_pallas_bidir,
)
from video_mamba_suite_torch.ops import (
    LAUNCHES,
    selective_scan_bidir,
    selective_scan_bidir_ref,
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


# fp32: the JAX kernel tests' own tolerance. bf16 I/O: one to two bf16 ulps
# after a scan whose state and arithmetic are fp32.
TOL = {"float32": dict(atol=2e-4, rtol=2e-4),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}

IO = ("uf", "dtf", "Bf", "Cf", "zf", "ub", "dtb", "Bb", "Cb", "zb")


def _inputs(seed, b, l, d, n):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    out = {}
    for s in "fb":
        out["u" + s] = rng.standard_normal((b, l, d)).astype(f32)
        out["dt" + s] = (0.5 * rng.random((b, l, d))).astype(f32)
        out["A" + s] = (-0.5 * rng.random((d, n))).astype(f32)
        out["B" + s] = rng.standard_normal((b, l, n)).astype(f32)
        out["C" + s] = rng.standard_normal((b, l, n)).astype(f32)
        out["D" + s] = rng.standard_normal(d).astype(f32)
        out["z" + s] = rng.standard_normal((b, l, d)).astype(f32)
        out["bias" + s] = (0.5 * rng.random(d)).astype(f32)
    return out


def _to_jax(arrs, dtype):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    return {k: jnp.asarray(v, jdt if k in IO else jnp.float32)
            for k, v in arrs.items()}


def _to_torch(arrs, dtype):
    tdt = getattr(torch, dtype)
    return {k: torch.from_numpy(v).to(tdt if k in IO else torch.float32)
            for k, v in arrs.items()}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# Each dtype meets every seqlen (11 and 13 take the JAX kernel's padding to
# 16) and every D/z combination; the full product is slow in interpret mode.
@pytest.mark.parametrize("dtype,seqlen,has_d,has_z", [
    ("float32", 16, True, True),
    ("float32", 11, False, False),
    ("float32", 13, True, False),
    ("bfloat16", 16, False, False),
    ("bfloat16", 11, True, False),
    ("bfloat16", 13, True, True),
])
def test_bidir_ref_matches_jax_pallas_interpret(dtype, seqlen, has_d, has_z):
    arrs = _inputs(seqlen + 7 * has_d + 13 * has_z, 3, seqlen, 8, 4)
    if not has_d:
        arrs.pop("Df"), arrs.pop("Db")
    if not has_z:
        arrs.pop("zf"), arrs.pop("zb")
    want_f, want_b = selective_scan_pallas_bidir(
        **_to_jax(arrs, dtype), delta_softplus=True, interpret=True)
    got_f, got_b = selective_scan_bidir_ref(**_to_torch(arrs, dtype))
    assert got_f.dtype == got_b.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(got_f), _np(want_f), **TOL[dtype])
    np.testing.assert_allclose(_np(got_b), _np(want_b), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scan_ref_matches_jax(dtype):
    arrs = _inputs(3, 2, 21, 8, 4)
    j = _to_jax(arrs, dtype)
    t = _to_torch(arrs, dtype)
    want = jax_scan_ref(j["uf"], j["dtf"], j["Af"], j["Bf"], j["Cf"],
                        D=j["Df"], z=j["zf"], delta_bias=j["biasf"],
                        delta_softplus=True)
    got = selective_scan_ref(t["uf"], t["dtf"], t["Af"], t["Bf"], t["Cf"],
                             D=t["Df"], z=t["zf"], delta_bias=t["biasf"],
                             delta_softplus=True)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
    # no softplus, no bias, no gate
    want = jax_scan_ref(j["uf"], j["dtf"], j["Af"], j["Bf"], j["Cf"])
    got = selective_scan_ref(t["uf"], t["dtf"], t["Af"], t["Bf"], t["Cf"])
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


def test_wrapper_on_cpu_takes_plain_version():
    t = _to_torch(_inputs(5, 2, 9, 8, 4), "float32")
    before = dict(LAUNCHES)
    got = selective_scan_bidir(**t)
    want = selective_scan_bidir_ref(**t)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=0, rtol=0)
    assert dict(LAUNCHES) == before


def test_wrapper_refuses_other_devices():
    t = _to_torch(_inputs(5, 2, 9, 8, 4), "float32")
    t = {k: v.to("meta") for k, v in t.items()}
    with pytest.raises(ValueError, match="unsupported device"):
        selective_scan_bidir(**t)
