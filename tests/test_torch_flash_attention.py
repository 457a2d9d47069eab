"""The port's flash attention (K11: ``flash_mha_ref``, ``flash_mha_bwd_ref``,
the autograd Function ``FlashMHA``) and ``FusedMHA(flash=True)`` against the
JAX package's ``_flash_mha`` on the CPU: the same numpy inputs through
jax's Pallas ``flash_attention`` in interpret mode (forward and ``jax.vjp``)
and through the port's plain versions."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from video_mamba_suite_torch.models.common import FusedMHA
from video_mamba_suite_torch.models.convert import _dense
from video_mamba_suite_torch.ops import (
    flash_mha,
    flash_mha_bwd,
    flash_mha_bwd_ref,
    flash_mha_fwd,
    flash_mha_ref,
)
from video_mamba_suite_tpu.models.common import FusedMHA as JaxFusedMHA
from video_mamba_suite_tpu.models.common import _flash_mha


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


JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# largest |port - JAX| over each output's largest magnitude (at least 1):
# fp32 read at most 5.4e-7 (sums in another order), held at 1e-5; bf16
# read at most 5e-4 (dq: a few elements one bf16 ulp apart, ds rounded on
# either side of a tie), held at ten times that
TOL = {"float32": 1e-5, "bfloat16": 5e-3}

# (L, dh, causal, dtype): L under, over and across the library's pad to
# 128, both head widths, causal and not, L 63, 64 and 65 at the card
# kernels' 64-row blocks and 64-key tiles, and bf16 at dh 128, the width
# whose tensor-core backward holds the most registers; then a width above
# 128 (two of the card kernels' 128-column slices) and one below 128 that
# is neither 64 nor 128 (zero-filled on the card) (each new (padded L, dh,
# causal, dtype) costs the JAX side a few seconds of compiling)
CASES = [
    (1, 64, True, "float32"),
    (77, 64, True, "float32"),
    (130, 64, False, "float32"),
    (130, 128, True, "float32"),
    (77, 64, True, "bfloat16"),
    (63, 64, True, "bfloat16"),
    (64, 64, False, "float32"),
    (65, 64, True, "float32"),
    (130, 128, False, "bfloat16"),
    (40, 256, True, "float32"),
    (40, 96, False, "float32"),
]
IDS = [f"L{c[0]}-dh{c[1]}-{'causal' if c[2] else 'full'}-{c[3]}"
       for c in CASES]
B, H = 2, 2


def _inputs(L, dh, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, L, H, dh)).astype(np.float32)
               for _ in range(3))
    g = rng.standard_normal((B, L, H * dh)).astype(np.float32)
    return q, k, v, g


@functools.lru_cache(maxsize=None)
def _jax_case(L, dh, causal, dtype):
    """The JAX ``_flash_mha`` (Pallas in interpret mode) on a case's
    inputs: (output, (dq, dk, dv)) as fp32 numpy."""
    q, k, v, g = _inputs(L, dh, L + dh)
    cast = functools.partial(jnp.asarray, dtype=JDT[dtype])
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(lambda *a: _flash_mha(*a, causal),
                           *(cast(t) for t in (q, k, v)))
        grads = vjp(cast(g))
    as_np = functools.partial(np.asarray, dtype=np.float32)
    return as_np(out), tuple(as_np(t) for t in grads)


def _port_inputs(L, dh, dtype, grad=False):
    return tuple(torch.from_numpy(t).to(TDT[dtype]).requires_grad_(grad)
                 for t in _inputs(L, dh, L + dh))


def _close(got, want, dtype):
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= TOL[dtype] * scale


@pytest.mark.parametrize("L,dh,causal,dtype", CASES, ids=IDS)
def test_flash_mha_ref_matches_jax(L, dh, causal, dtype):
    """Forward and backward plain versions against the Pallas kernel and
    its VJP: the output and dq, dk, dv."""
    want_out, want_grads = _jax_case(L, dh, causal, dtype)
    q, k, v, g = _port_inputs(L, dh, dtype)
    out, lse = flash_mha_ref(q, k, v, causal)
    assert out.dtype == TDT[dtype] and lse.dtype == torch.float32
    assert lse.shape == (B, H, L)
    _close(out, want_out, dtype)
    grads = flash_mha_bwd_ref(q, k, v, out, lse, g, causal)
    for got, want, t in zip(grads, want_grads, (q, k, v)):
        assert got.dtype == t.dtype
        _close(got, want, dtype)


@pytest.mark.parametrize("L,dh,causal,dtype", CASES, ids=IDS)
def test_flash_mha_function_on_cpu_matches_jax(L, dh, causal, dtype):
    """``flash_mha`` (the autograd Function FlashMHA on its CPU route)
    forward and backward against the same."""
    want_out, want_grads = _jax_case(L, dh, causal, dtype)
    q, k, v, g = _port_inputs(L, dh, dtype, grad=True)
    out = flash_mha(q, k, v, causal)
    _close(out, want_out, dtype)
    out.backward(g.detach())
    for t, want in zip((q, k, v), want_grads):
        _close(t.grad, want, dtype)


def test_lse_is_the_log_sum_exp_of_the_scaled_scores():
    q, k, v, _ = _port_inputs(9, 64, "float32")
    _, lse = flash_mha_ref(q, k, v, causal=True)
    s = torch.einsum("bihc,bjhc->bhij", q, k) / 8.0
    s = s.masked_fill(~torch.ones(9, 9, dtype=torch.bool).tril(), -torch.inf)
    assert torch.allclose(lse, torch.logsumexp(s, dim=-1), atol=1e-6)


def test_fused_mha_flash_true_with_jax_weights():
    """FusedMHA(flash=True) loaded from a JAX FusedMHA tree through
    ``_dense``: on the CPU it is the JAX module (the einsum path, as off the
    TPU), and its projections around ``flash_mha`` (FlashMHA's CPU route)
    equal ``_flash_mha`` in interpret mode on the JAX module's own q, k and
    v."""
    Bx, L, D, heads = 2, 20, 128, 2
    x = np.random.default_rng(5).standard_normal((Bx, L, D)).astype(
        np.float32)
    jm = JaxFusedMHA(num_heads=heads, causal=True, flash=True)
    params = jm.init(jax.random.PRNGKey(5), jnp.asarray(x))
    state = {}
    for name in ("qkv", "out"):
        _dense(params["params"][name], f"{name}.", state)
    mha = FusedMHA(D, heads, causal=True, flash=True,
                   generator=torch.Generator())
    mha.load_state_dict(state)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        got = mha(xt)
        q, k, v = (t.view(Bx, L, heads, D // heads)
                   for t in mha.qkv(xt).chunk(3, dim=-1))
        flash = mha.out(flash_mha(q, k, v, causal=True))
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    assert np.abs(got.numpy() - want).max() <= 1e-5

    p = params["params"]
    qkv = jnp.asarray(x) @ p["qkv"]["kernel"] + p["qkv"]["bias"]
    jq, jk, jv = (t.reshape(Bx, L, heads, D // heads)
                  for t in jnp.split(qkv, 3, axis=-1))
    with pltpu.force_tpu_interpret_mode():
        attn = _flash_mha(jq, jk, jv, True)
    want_flash = np.asarray(attn @ p["out"]["kernel"] + p["out"]["bias"])
    assert np.abs(flash.numpy() - want_flash).max() <= 1e-5
    assert np.abs(flash.numpy() - want).max() <= 1e-5


def test_kernel_wrappers_refuse_cpu_tensors():
    q = torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError, match="launches a CUDA kernel"):
        flash_mha_fwd(q, q, q)
    out, lse = torch.zeros(1, 8, 128), torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="launches a CUDA kernel"):
        flash_mha_bwd(q, q, q, out, lse, out)
