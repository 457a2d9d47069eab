"""The port's whole-row attention (K9 ``vision_mha``, K10 ``row_mha_qkv``)
and ``FusedMHA`` against the JAX package's, on the CPU: the same numpy
inputs through the JAX functions (their Pallas kernels in interpret mode,
as the JAX package's own tests run them) and through the port's plain
versions and autograd Functions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_mamba_suite_torch.models.common import FusedMHA
from video_mamba_suite_torch.ops import (
    row_mha_fwd,
    row_mha_qkv,
    row_mha_qkv_ref,
    vision_mha,
    vision_mha_fwd,
    vision_mha_ref,
)
from video_mamba_suite_tpu.models.common import FusedMHA as JaxFusedMHA
from video_mamba_suite_tpu.ops import vision_attention as jva


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


# largest |port - JAX|: as the JAX tests hold the kernels against their
# einsum reference (fp32: sums in another order; bf16: the output's and the
# weights' roundings on either side of a tie, one to two ulps of values
# below 4)
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 3, 4, 37, 16), (1, 2, 2, 197, 8),
                                   (1, 1, 2, 29, 200)])
def test_row_mha_qkv_ref_matches_jax_kernel(shape, dtype):
    """dh 200: above the card kernel's 128, in two column slices there."""
    B, T, H, N, dh = shape
    x = _rand((B, T, 3 * H, N, dh), sum(shape))
    want = jva.row_mha_qkv(jnp.asarray(x, JDT[dtype]), interpret=True)
    got = row_mha_qkv_ref(torch.from_numpy(x).to(TDT[dtype]))
    assert got.dtype == TDT[dtype] and got.shape == (B, T, H, N, dh)
    assert np.abs(got.float().numpy() - _np(want)).max() <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 3, 37, 16), (2, 2, 197, 8),
                                   (2, 2, 16, 8), (2, 1, 17, 16),
                                   (1, 2, 256, 8), (1, 1, 257, 16),
                                   (1, 2, 29, 200)])
def test_vision_mha_ref_matches_jax_kernel(shape, dtype):
    """K9 scales q in its own dtype: at dh 8 the bf16 scale (0.3535) is
    rounded, which the plain version keeps. N 16, 17, 256 and 257 are the
    edges of the card kernel's 16-row warps and 64-key tiles; dh 200 is
    above its 128, in two column slices there."""
    q, k, v = (_rand(shape, sum(shape) + i) for i in range(3))
    want = jva.vision_mha(*(jnp.asarray(t, JDT[dtype]) for t in (q, k, v)),
                          interpret=True)
    got = vision_mha_ref(*(torch.from_numpy(t).to(TDT[dtype])
                           for t in (q, k, v)))
    assert got.dtype == TDT[dtype] and got.shape == shape
    assert np.abs(got.float().numpy() - _np(want)).max() <= TOL[dtype]


def test_k9_card_quotient_is_the_correctly_rounded_one():
    """The card's K9 forms w = e / sum as q = e r, w = q + (e - sum q) r
    with r = 1 / sum (fp32, each step rounded once, the residual by an
    FMA): Markstein's correction, which gives the correctly rounded
    quotient that the plain version's division does. Held here against
    exact rational division at the values the kernel sees (e in (0, 1],
    sums of up to 512 such terms)."""
    from fractions import Fraction

    def rn(x: Fraction) -> np.float32:             # x rounded to fp32
        c = np.float32(float(x))
        below, above = (np.nextafter(c, np.float32(d)) for d in
                        (-np.inf, np.inf))
        return min((below, c, above), key=lambda y: (
            abs(Fraction(float(y)) - x),
            int(np.float32(y).view(np.uint32)) & 1))

    rng = np.random.default_rng(0)
    for _ in range(2000):
        e = Fraction(float(np.float32(np.exp(rng.uniform(-30.0, 0.0)))))
        s = Fraction(float(np.float32(rng.uniform(1.0, 512.0))))
        r = Fraction(float(rn(1 / s)))
        q = Fraction(float(rn(e * r)))
        res = Fraction(float(rn(e - s * q)))
        assert rn(q + res * r) == rn(e / s)


def test_row_mha_qkv_gradient_matches_jax():
    B, T, H, N, dh = 2, 2, 3, 29, 16
    x = _rand((B, T, 3 * H, N, dh), 1)
    g = _rand((B, T, H, N, dh), 2)
    want = jax.grad(lambda a: jnp.sum(
        jva.row_mha_qkv(a, interpret=True) * g))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    (row_mha_qkv(xt) * torch.from_numpy(g)).sum().backward()
    assert np.abs(xt.grad.numpy() - np.asarray(want)).max() <= 1e-5


def test_vision_mha_gradient_matches_jax():
    shape = (3, 2, 29, 16)
    q, k, v, g = (_rand(shape, 5 + i) for i in range(4))
    want = jax.grad(lambda *a: jnp.sum(jva.vision_mha(*a, interpret=True)
                                       * g), argnums=(0, 1, 2))(q, k, v)
    ts = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    (vision_mha(*ts) * torch.from_numpy(g)).sum().backward()
    for t, w in zip(ts, want):
        assert np.abs(t.grad.numpy() - np.asarray(w)).max() <= 1e-5


def test_refusals():
    """Where the JAX functions raise, and the kernel entries given CPU
    tensors."""
    long_row = torch.zeros(1, 1, 513, 8)
    with pytest.raises(ValueError, match="whole-row limit"):
        vision_mha(long_row, long_row, long_row)
    with pytest.raises(ValueError, match="not divisible by 3"):
        row_mha_qkv(torch.zeros(1, 1, 4, 8, 8))
    with pytest.raises(ValueError, match="whole-row limit"):
        row_mha_qkv(torch.zeros(1, 1, 3, 513, 8))
    x = torch.zeros(1, 1, 3, 8, 8)
    with pytest.raises(ValueError, match="launches a CUDA kernel"):
        row_mha_fwd(x)
    with pytest.raises(ValueError, match="launches a CUDA kernel"):
        vision_mha_fwd(x[0], x[0], x[0])


def _jax_to_port(mha, params):
    """Load a JAX FusedMHA tree {qkv, out} into the port's module."""
    p = params["params"]
    state = {}
    for name in ("qkv", "out"):
        state[f"{name}.weight"] = torch.from_numpy(
            np.array(p[name]["kernel"]).T.copy())
        state[f"{name}.bias"] = torch.from_numpy(np.array(p[name]["bias"]))
    mha.load_state_dict(state)
    return mha


def _port(D, H, params, **kw):
    return _jax_to_port(FusedMHA(D, H, generator=torch.Generator(), **kw),
                        params)


def _param_grads(module, x, g):
    out = module(torch.from_numpy(x))
    (out * torch.from_numpy(g)).sum().backward()
    return out.detach().numpy(), {n: p.grad.numpy()
                                  for n, p in module.named_parameters()}


def test_fused_mha_row_matches_einsum_path_and_jax():
    """FusedMHA(flash="row") from the same parameters as FusedMHA(): the
    same function as the einsum path and as the JAX row path (K10 in
    interpret mode), outputs within 1e-5 and parameter gradients within
    1e-4."""
    B, S, T, D, H = 2, 37, 3, 32, 4
    x = _rand((B, S, T, D), 0)
    g = _rand((B, S, T, D), 1)
    jrow = JaxFusedMHA(num_heads=H, seq_axis=1, flash="row")
    params = jrow.init(jax.random.PRNGKey(1), jnp.asarray(x))
    want = jrow.apply(params, jnp.asarray(x))
    want_g = jax.grad(lambda p: jnp.sum(jrow.apply(p, jnp.asarray(x)) * g))(
        params)["params"]
    got, got_g = _param_grads(_port(D, H, params, flash="row", seq_axis=1),
                              x, g)
    base, base_g = _param_grads(_port(D, H, params, seq_axis=1), x, g)
    assert np.abs(got - np.asarray(want)).max() <= 1e-5
    assert np.abs(got - base).max() <= 1e-5
    for name in ("qkv", "out"):
        for key, jkey in (("weight", "kernel"), ("bias", "bias")):
            jg = np.asarray(want_g[name][jkey])
            jg = jg.T if key == "weight" else jg
            assert np.abs(got_g[f"{name}.{key}"] - jg).max() <= 1e-4
            assert np.abs(got_g[f"{name}.{key}"]
                          - base_g[f"{name}.{key}"]).max() <= 1e-4


@pytest.mark.parametrize("causal", [False, True])
def test_fused_mha_3d_matches_jax(causal):
    """The (B, L, D) einsum path, causal (the mask at -1e30) and not."""
    B, L, D, H = 3, 9, 32, 4
    x = _rand((B, L, D), 2)
    jm = JaxFusedMHA(num_heads=H, causal=causal)
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(x))
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = _port(D, H, params, causal=causal)(torch.from_numpy(x))
    assert np.abs(got.numpy() - want).max() <= 1e-5


def test_fused_mha_vmem_matches_jax():
    """flash="vmem" on a 3-D input: K9 (interpret mode in JAX, the plain
    version here)."""
    B, L, D, H = 2, 37, 32, 4
    x = _rand((B, L, D), 3)
    jm = JaxFusedMHA(num_heads=H, flash="vmem")
    params = jm.init(jax.random.PRNGKey(3), jnp.asarray(x))
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = _port(D, H, params, flash="vmem")(torch.from_numpy(x))
        plain = _port(D, H, params)(torch.from_numpy(x))
    assert np.abs(got.numpy() - want).max() <= 1e-5
    assert np.abs(got.numpy() - plain.numpy()).max() <= 1e-5


def test_fused_mha_flash_true_on_cpu_is_the_einsum_path():
    """flash=True off the card computes the einsum path, as the JAX package
    does off the TPU; the seq_axis=1 path refuses it and causal."""
    B, L, D, H = 2, 11, 128, 2
    x = torch.from_numpy(_rand((B, L, D), 4))
    flash = FusedMHA(D, H, flash=True, causal=True,
                     generator=torch.Generator().manual_seed(0))
    plain = FusedMHA(D, H, causal=True,
                     generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert torch.equal(flash(x), plain(x))
    x4 = torch.zeros(1, 5, 2, D)
    for kw in (dict(flash=True), dict(flash="vmem"), dict(causal=True)):
        mha = FusedMHA(D, H, seq_axis=1, generator=torch.Generator(), **kw)
        with pytest.raises(ValueError, match="bidirectional"):
            mha(x4)
