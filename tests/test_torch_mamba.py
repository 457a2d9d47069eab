"""The port's conv, mixer bodies, norms, MambaVim and MambaScanNorm against
the JAX package's, on the CPU, from the same numpy inputs and weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_mamba_suite_tpu.models.mamba import MambaScanNorm as JaxScanNorm
from video_mamba_suite_tpu.models.mamba import MambaVim as JaxMambaVim
from video_mamba_suite_tpu.ops import norms as jax_norms
from video_mamba_suite_tpu.ops.causal_conv1d import causal_conv1d_ref
from video_mamba_suite_tpu.ops.mamba_inner import (
    mamba_inner as jax_mamba_inner,
)
from video_mamba_suite_tpu.ops.mamba_inner import (
    mamba_inner_bidir as jax_mamba_inner_bidir,
)
from video_mamba_suite_torch.models import (
    MambaScanNorm,
    MambaVim,
    vim_mixer_from_jax,
)
from video_mamba_suite_torch.models.mamba import use_fused_scan
from video_mamba_suite_torch.ops import (
    causal_conv1d,
    fused_add_norm,
    layer_norm,
    mamba_inner,
    mamba_inner_bidir,
    rms_norm,
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


F32 = dict(atol=1e-4, rtol=1e-4)
# the modules of the long-sequence slice: fp32 at 2e-5
TIGHT = dict(atol=2e-5, rtol=2e-5)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv1d_matches_jax(reverse, dtype):
    rng = np.random.default_rng(int(reverse))
    x = rng.standard_normal((2, 13, 8)).astype(np.float32)
    w = rng.standard_normal((4, 8)).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)
    want = causal_conv1d_ref(jnp.asarray(x, getattr(jnp, dtype)),
                             jnp.asarray(w), jnp.asarray(b),
                             activation="silu", reverse=reverse)
    got = causal_conv1d(torch.from_numpy(x).to(getattr(torch, dtype)),
                        torch.from_numpy(w), torch.from_numpy(b),
                        activation="silu", reverse=reverse)
    assert got.dtype == getattr(torch, dtype)
    tol = F32 if dtype == "float32" else dict(atol=1e-2, rtol=1e-2)
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _scan_bundle(rng, d_inner, d_state, dt_rank, width=4):
    f32 = np.float32
    return dict(
        conv_w=rng.standard_normal((width, d_inner)).astype(f32) * 0.5,
        conv_b=rng.standard_normal(d_inner).astype(f32) * 0.1,
        x_proj=rng.standard_normal((d_inner, dt_rank + 2 * d_state)).astype(
            f32) / np.sqrt(d_inner),
        dt_proj=rng.standard_normal((dt_rank, d_inner)).astype(f32)
        / np.sqrt(dt_rank),
        dt_bias=rng.uniform(-4, -2, d_inner).astype(f32),
        D=np.ones(d_inner, f32),
        A=-np.tile(np.arange(1, d_state + 1, dtype=f32), (d_inner, 1)),
    )


def _torch_bundle(p):
    out = {k: torch.from_numpy(v) for k, v in p.items()}
    out["x_proj"] = out["x_proj"].t()   # (in, out) → (out, in)
    out["dt_proj"] = out["dt_proj"].t()
    return out


def test_mamba_inner_bidir_with_mask_matches_jax():
    """Masked steps are identity scan elements (MASKED_DELTA). On the CPU
    the JAX function takes its flip branch: the same function."""
    rng = np.random.default_rng(0)
    b, l, d_inner, d_state, dt_rank = 3, 12, 16, 8, 2
    xz = rng.standard_normal((b, l, 2 * d_inner)).astype(np.float32)
    mask = np.ones((b, l), np.float32)
    mask[0, 9:] = 0
    mask[2, :3] = 0
    fwd = _scan_bundle(rng, d_inner, d_state, dt_rank)
    bwd = _scan_bundle(rng, d_inner, d_state, dt_rank)
    jf = {k: jnp.asarray(v) for k, v in fwd.items()}
    jb = {k: jnp.asarray(v) for k, v in bwd.items()}
    want = jax.jit(jax_mamba_inner_bidir)(
        jnp.asarray(xz), jnp.asarray(xz), jf, jb, jf["A"], jb["A"],
        mask=jnp.asarray(mask))
    tf, tb = _torch_bundle(fwd), _torch_bundle(bwd)
    got = mamba_inner_bidir(torch.from_numpy(xz), torch.from_numpy(xz),
                            tf, tb, tf["A"], tb["A"],
                            mask=torch.from_numpy(mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **F32)


@pytest.mark.parametrize("if_devide_out,masked", [(False, False),
                                                  (True, True)])
def test_mamba_vim_matches_jax(if_devide_out, masked):
    b, l, d_model = 3, 16, 32
    rng = np.random.default_rng(1)
    x = rng.standard_normal((b, l, d_model)).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((b, l), np.float32)
        mask[1, 11:] = 0
    jm = JaxMambaVim(d_model=d_model, d_state=16, expand=1,
                     if_devide_out=if_devide_out)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    want = jax.jit(jm.apply)(
        params, jnp.asarray(x),
        mask=None if mask is None else jnp.asarray(mask))

    tm = MambaVim(d_model=d_model, d_state=16, expand=1,
                  if_devide_out=if_devide_out, device="cpu")
    sd = vim_mixer_from_jax(jax.tree_util.tree_map(np.asarray, params))
    tm.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x),
                 mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(_np(got), _np(want), **F32)


@pytest.mark.parametrize("reverse,masked,out_proj", [
    (False, False, True),
    (True, True, False),
    (True, False, True),
])
def test_mamba_inner_matches_jax(reverse, masked, out_proj):
    """One direction at seqlen 70 (the chunked scan's route), with and
    without mask, reverse and out_proj, and its last state."""
    rng = np.random.default_rng(10 + 2 * reverse + masked)
    b, l, d_inner, d_state, dt_rank, d_model = 2, 70, 16, 8, 2, 12
    xz = rng.standard_normal((b, l, 2 * d_inner)).astype(np.float32)
    p = _scan_bundle(rng, d_inner, d_state, dt_rank)
    w_out = (rng.standard_normal((d_inner, d_model))
             / np.sqrt(d_inner)).astype(np.float32)
    b_out = rng.standard_normal(d_model).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((b, l), np.float32)
        mask[0, 50:] = 0
        mask[1, :7] = 0
    want, want_last = jax_mamba_inner(
        jnp.asarray(xz), jnp.asarray(p["conv_w"]), jnp.asarray(p["conv_b"]),
        jnp.asarray(p["x_proj"]), jnp.asarray(p["dt_proj"]),
        jnp.asarray(p["A"]), D=jnp.asarray(p["D"]),
        delta_bias=jnp.asarray(p["dt_bias"]),
        out_proj_weight=jnp.asarray(w_out) if out_proj else None,
        out_proj_bias=jnp.asarray(b_out) if out_proj else None,
        mask=None if mask is None else jnp.asarray(mask),
        return_last_state=True, reverse=reverse)
    t = _torch_bundle(p)
    got, got_last = mamba_inner(
        torch.from_numpy(xz), t["conv_w"], t["conv_b"], t["x_proj"],
        t["dt_proj"], t["A"], D=t["D"], delta_bias=t["dt_bias"],
        out_proj_weight=torch.from_numpy(w_out).t() if out_proj else None,
        out_proj_bias=torch.from_numpy(b_out) if out_proj else None,
        mask=None if mask is None else torch.from_numpy(mask),
        return_last_state=True, reverse=reverse)
    assert got.shape == (b, l, d_model if out_proj else d_inner)
    np.testing.assert_allclose(_np(got), _np(want), **TIGHT)
    np.testing.assert_allclose(_np(got_last), _np(want_last), **TIGHT)


@pytest.mark.parametrize("is_rms_norm,residual,prenorm", [
    (False, False, True),
    (False, True, True),
    (True, True, True),
    (True, True, False),
])
def test_fused_add_norm_matches_jax(is_rms_norm, residual, prenorm):
    rng = np.random.default_rng(20 + 2 * is_rms_norm + residual)
    x = rng.standard_normal((2, 7, 24)).astype(np.float32)
    res = rng.standard_normal((2, 7, 24)).astype(np.float32) * 3
    w = rng.standard_normal(24).astype(np.float32)
    bias = None if is_rms_norm else rng.standard_normal(24).astype(np.float32)
    want = jax_norms.fused_add_norm(
        jnp.asarray(x), jnp.asarray(w),
        None if bias is None else jnp.asarray(bias),
        residual=jnp.asarray(res) if residual else None, prenorm=prenorm,
        is_rms_norm=is_rms_norm)
    got = fused_add_norm(
        torch.from_numpy(x), torch.from_numpy(w),
        None if bias is None else torch.from_numpy(bias),
        residual=torch.from_numpy(res) if residual else None,
        prenorm=prenorm, is_rms_norm=is_rms_norm)
    np.testing.assert_allclose(_np(got[0]), _np(want[0]), **TIGHT)
    if prenorm:
        assert got[1].dtype == torch.float32
        np.testing.assert_allclose(_np(got[1]), _np(want[1]), **TIGHT)
    else:
        assert got[1] is None and want[1] is None


def test_norms_keep_dtype_and_match_jax():
    """layer_norm and rms_norm (with a bias) in fp32 at 2e-5; in bf16 the
    output keeps bf16, one bf16 ulp (2^-8 relative) from JAX's after an fp32
    computation, and the prenorm residual stays fp32."""
    rng = np.random.default_rng(30)
    x = rng.standard_normal((3, 40)).astype(np.float32)
    w = rng.standard_normal(40).astype(np.float32)
    b = rng.standard_normal(40).astype(np.float32)
    for jfn, tfn in ((jax_norms.layer_norm, layer_norm),
                     (jax_norms.rms_norm, rms_norm)):
        want = jfn(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), eps=1e-6)
        got = tfn(torch.from_numpy(x), torch.from_numpy(w),
                  torch.from_numpy(b), eps=1e-6)
        np.testing.assert_allclose(_np(got), _np(want), **TIGHT)
        want = jfn(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w))
        got = tfn(torch.from_numpy(x).bfloat16(), torch.from_numpy(w))
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-2,
                                   rtol=2 ** -8)
    normed, res = fused_add_norm(torch.from_numpy(x).bfloat16(),
                                 torch.from_numpy(w))
    assert normed.dtype == torch.bfloat16 and res.dtype == torch.float32


@pytest.mark.parametrize("mixer", ["vim", "scan_norm"])
@pytest.mark.parametrize("seqlen", [16, 74])
def test_mixers_match_jax_on_both_routes(mixer, seqlen):
    """Seqlen 16 takes the fused pair (K1's route on the card), seqlen 74
    one chunked scan per direction (K3's route); both against the JAX
    mixer with its defaults (expand 2, if_devide_out off)."""
    assert use_fused_scan(seqlen) == (seqlen == 16)
    b, d_model = 2, 16
    rng = np.random.default_rng(seqlen)
    x = rng.standard_normal((b, seqlen, d_model)).astype(np.float32)
    jcls, tcls = ((JaxScanNorm, MambaScanNorm) if mixer == "scan_norm"
                  else (JaxMambaVim, MambaVim))
    jm = jcls(d_model=d_model, d_state=8)
    params = jax.jit(jm.init)(jax.random.PRNGKey(seqlen), jnp.asarray(x))
    params = jax.tree_util.tree_map(np.asarray, params)
    if mixer == "scan_norm":           # a norm weight that is not all ones
        params["params"]["scan_norm_w"] = rng.uniform(
            0.5, 1.5, params["params"]["scan_norm_w"].shape).astype(
                np.float32)
    want = jm.apply(params, jnp.asarray(x))
    tm = tcls(d_model=d_model, d_state=8, device="cpu")
    tm.load_state_dict(vim_mixer_from_jax(params), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), _np(want), **TIGHT)


def test_scan_params_call_runs_its_direction():
    """ScanParams(xz) is its direction's mamba_inner, as the JAX
    ``_ScanParams.__call__``."""
    tm = MambaVim(d_model=8, d_state=4, device="cpu")
    xz = torch.randn(2, 70, 32, generator=torch.Generator().manual_seed(0))
    p = tm.bwd
    with torch.no_grad():
        got, last = p(xz, reverse=True, return_last_state=True)
        want, want_last = mamba_inner(
            xz, p.conv_w, p.conv_bias, p.x_proj, p.dt_proj, p.A(), D=p.D,
            delta_bias=p.dt_bias, return_last_state=True, reverse=True)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    torch.testing.assert_close(last, want_last, atol=0, rtol=0)
