"""The port's one-direction selective scan against the JAX package's.

The plain version (``selective_scan`` on CPU tensors) runs here: against
the JAX ``selective_scan(impl="ref")`` with every option the chunked
kernel K3 takes, and against ``selective_scan_pallas`` in Pallas interpret
mode at lengths above 64 or with an initial state, so that the JAX call
reaches K3's TPU bodies (``_fwd_kernel`` at batch > 4, ``_fwd_kernel_hs``
at batch <= 4) and not the short kernel. The same numpy inputs feed both
frameworks. The CUDA kernel itself is held against the plain version in
``test_torch_kernels_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_mamba_suite_tpu.ops import selective_scan as jax_selective_scan
from video_mamba_suite_tpu.ops.selective_scan_pallas import (
    selective_scan_pallas,
)
from video_mamba_suite_torch.ops import (
    LAUNCHES,
    chunked_scan_fwd,
    selective_scan,
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


# fp32 throughout, against both the JAX reference and the Pallas bodies
TOL = dict(atol=2e-5, rtol=2e-5)


def _inputs(seed, b, l, d, n, groups=0):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    bc = (b, l, groups, n) if groups else (b, l, n)
    return dict(
        u=rng.standard_normal((b, l, d)).astype(f32),
        delta=(0.5 * rng.random((b, l, d)) - 0.25).astype(f32),
        A=(-rng.random((d, n)) - 0.1).astype(f32),
        B=rng.standard_normal(bc).astype(f32),
        C=rng.standard_normal(bc).astype(f32),
        D=rng.standard_normal(d).astype(f32),
        z=rng.standard_normal((b, l, d)).astype(f32),
        delta_bias=(0.5 * rng.random(d)).astype(f32),
        initial_state=rng.standard_normal((b, d, n)).astype(f32),
    )


def _split(arrs, has_dz=True, h0=True):
    arrs = dict(arrs)
    if not has_dz:
        arrs.pop("D"), arrs.pop("z")
    if not h0:
        arrs.pop("initial_state")
    return arrs


def _jax(arrs):
    return {k: jnp.asarray(v) for k, v in arrs.items()}


def _torch(arrs):
    return {k: torch.from_numpy(v) for k, v in arrs.items()}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("reverse,groups,has_dz", [
    (False, 0, True),
    (True, 0, True),
    (False, 2, False),
    (True, 4, True),
])
def test_plain_scan_matches_jax_ref(reverse, groups, has_dz):
    arrs = _split(_inputs(7 + groups, 2, 19, 8, 4, groups), has_dz, h0=False)
    want, want_last = jax_selective_scan(
        **_jax(arrs), delta_softplus=True, return_last_state=True,
        impl="ref", reverse=reverse)
    got, got_last = selective_scan(
        **_torch(arrs), delta_softplus=True, return_last_state=True,
        reverse=reverse)
    assert got.dtype == torch.float32 and got_last.shape == (2, 8, 4)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    np.testing.assert_allclose(_np(got_last), _np(want_last), **TOL)


def test_plain_scan_without_softplus_or_bias_matches_jax_ref():
    arrs = _inputs(3, 2, 13, 8, 4)
    for k in ("D", "z", "delta_bias", "initial_state"):
        arrs.pop(k)
    arrs["delta"] = np.abs(arrs["delta"])
    want = jax_selective_scan(**_jax(arrs), impl="ref")
    got = selective_scan(**_torch(arrs))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


# batch 5 reaches _fwd_kernel (reverse flip-free), batch 2 _fwd_kernel_hs
# (reverse through flips); seqlen 72 > 64, or an initial state at 20,
# keeps the JAX call off the short kernel. Grouped B/C at G = 2.
@pytest.mark.parametrize("batch,seqlen,reverse,groups,h0", [
    (5, 72, False, 0, True),
    (5, 72, True, 0, True),
    (5, 72, True, 2, False),
    (2, 72, False, 0, False),
    (2, 20, True, 0, True),
])
def test_plain_scan_matches_jax_pallas_interpret(batch, seqlen, reverse,
                                                 groups, h0):
    arrs = _split(_inputs(seqlen + batch + groups, batch, seqlen, 16, 4,
                          groups), h0=h0)
    want, want_last = selective_scan_pallas(
        **_jax(arrs), delta_softplus=True, return_last_state=True,
        chunk=8, interpret=True, reverse=reverse)
    got, got_last = selective_scan(
        **_torch(arrs), delta_softplus=True, return_last_state=True,
        reverse=reverse)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    np.testing.assert_allclose(_np(got_last), _np(want_last), **TOL)


def test_reverse_with_initial_state_enters_at_the_end():
    """reverse is flip∘scan∘flip: the initial state enters at t = L - 1
    and the last state is the one at t = 0."""
    t = _torch(_inputs(11, 2, 9, 8, 4))
    got, last = selective_scan_ref(**t, delta_softplus=True,
                                   return_last_state=True, reverse=True)

    def flip(x):
        return torch.flip(x, dims=(1,))

    want, want_last = selective_scan_ref(
        flip(t["u"]), flip(t["delta"]), t["A"], flip(t["B"]), flip(t["C"]),
        D=t["D"], z=flip(t["z"]), delta_bias=t["delta_bias"],
        delta_softplus=True, return_last_state=True,
        initial_state=t["initial_state"])
    torch.testing.assert_close(got, flip(want), atol=0, rtol=0)
    torch.testing.assert_close(last, want_last, atol=0, rtol=0)


def test_front_end_on_cpu_takes_plain_version():
    t = _torch(_inputs(5, 2, 70, 8, 4))
    before = dict(LAUNCHES)
    got = selective_scan(**t, delta_softplus=True, reverse=True)
    want = selective_scan_ref(**t, delta_softplus=True, reverse=True)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert dict(LAUNCHES) == before


def test_front_end_refuses_other_devices():
    t = {k: v.to("meta") for k, v in _torch(_inputs(5, 2, 9, 8, 4)).items()}
    with pytest.raises(ValueError, match="unsupported device"):
        selective_scan(**t)


def test_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA kernel"):
        chunked_scan_fwd(**_torch(_inputs(5, 2, 9, 8, 4)))
