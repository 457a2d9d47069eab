"""K5's and K6's walks of the short one-direction scan, in plain torch
(``test_torch_short_scan_units.py``, whose helpers this uses), at its
longest: 64 steps, causal, four whole units of 16. The adjoint is held
against ``jax.vjp`` through the JAX short path's ``_short_bwd_kernel`` in
Pallas interpret mode, which compiles for 25-30 s on the CPU at this
length, so the case has a file of its own; the forward against the JAX
plain scan.
"""

import jax
import pytest
import torch

from test_torch_short_scan_bwd import ORDER, _assert_grads, _jax_vjp
from test_torch_short_scan_units import (
    _case,
    _unit_adjoint,
    _unit_forward,
    assert_close,
)
from video_mamba_suite_tpu.ops import selective_scan as jax_selective_scan


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


def test_unit_adjoint_matches_jax_short_kernel_l64_causal():
    """The forward pass carries the starts of units 1 to 3 and the adjoint
    carries dh across all four units; every gradient within the plain K6's
    fp32 tolerance of its scale."""
    jax_args, args, g, g_last = _case(64, 0)
    want = _jax_vjp(jax_args, g, g_last, delta_softplus=True,
                    return_last_state=True)
    _assert_grads(_unit_adjoint(args, False), want, "float32", ORDER)


def test_unit_forward_matches_jax_ref_l64_causal():
    """K5's four units from a zero state: the output and the last state."""
    jax_args, args, _, _ = _case(64, 0)
    want = jax_selective_scan(**jax_args, impl="ref", delta_softplus=True,
                              return_last_state=True)
    for got, w in zip(_unit_forward(args, False), want):
        assert_close(got, w)
