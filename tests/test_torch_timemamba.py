"""The port's TimeMamba against the JAX package's, end to end on the CPU:
the same numpy clip and the JAX weights carried over by
``timemamba_from_jax``, from both the unrolled and the stacked
(``scan_blocks=True``) parameter trees."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from video_mamba_suite_tpu.models.convert import stack_block_params
from video_mamba_suite_tpu.models.timemamba import Mlp as JaxMlp
from video_mamba_suite_tpu.models.timemamba import TimeMamba as JaxTimeMamba
from video_mamba_suite_torch.models import TimeMamba, timemamba_from_jax
from video_mamba_suite_torch.models.timemamba import Mlp


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


SMALL = dict(img_size=32, patch_size=16, embed_dim=32, depth=2, num_heads=2,
             num_frames=8, ln_pre=True, output_dim=16)
F32 = dict(atol=1e-4, rtol=1e-4)
# Readings from tests/measure_torch_bf16_gap.py.
# bf16, whole model: max |port - JAX| over the output scale read 5.9e-3 on
# this test's clip (3.5e-3 and 6.7e-3 on two other seeds). The two
# frameworks round to bf16 at other places (matmul epilogues, softmax, the
# GELU's inner steps), and at the output that rounding is independent
# noise: a port computing in fp32 reads 3.8e-3 to 7.3e-3 on the same three
# clips, one using the exact GELU 3.6e-3 to 6.0e-3. So this bound catches
# gross errors only; the policy itself is held layer by layer below.
BF16_REL = 1.5e-2
# bf16 Mlp: mean |port - JAX| over mean |JAX| read 2.5e-3 to 2.7e-3 on four
# seeds with the bf16 policy and 4.6e-3 to 4.9e-3 for the same layer
# computing in fp32.
MLP_BF16_MEAN_REL = 3.5e-3


@pytest.fixture(scope="module")
def gated_params():
    """One JAX parameter tree (unrolled, with tanh gates) for every case:
    the attention styles share its structure. The gates are moved off 0,
    which would hide the temporal branch from the comparison."""
    model = JaxTimeMamba(**SMALL, is_tanh_gating=True, impl="assoc")
    params = jax.jit(model.init)({"params": jax.random.PRNGKey(3)},
                                 jnp.zeros((1, 8, 32, 32, 3)))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    for i in range(SMALL["depth"]):
        params[f"block{i}"]["alpha_timeattn"] = np.float32(0.7)
    return params


def _ungated(params):
    out = dict(params)
    for i in range(SMALL["depth"]):
        out[f"block{i}"] = {k: v for k, v in params[f"block{i}"].items()
                            if k != "alpha_timeattn"}
    return out


def _clip(seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((2, 8, 32, 32, 3)).astype(np.float32)


def _compare(params, x, jdtype=None, tdtype=None, scan_blocks=False, **kw):
    jm = JaxTimeMamba(**SMALL, **kw, impl="assoc", dtype=jdtype,
                      scan_blocks=scan_blocks)
    want = jax.jit(jm.apply)({"params": params},
                             jnp.asarray(x, jdtype or jnp.float32))
    want = np.asarray(jnp.asarray(want, jnp.float32))

    tm = TimeMamba(**SMALL, **kw, dtype=tdtype, device="cpu")
    tm.load_state_dict(timemamba_from_jax({"params": params},
                                          SMALL["depth"]), strict=True)
    block_dtypes = []
    for blk in tm.blocks:
        blk.register_forward_hook(
            lambda m, i, out: block_dtypes.extend(o.dtype for o in out))
    with torch.no_grad():
        got = tm(torch.from_numpy(x).to(tdtype or torch.float32))
    # blocks compute in the compute dtype, the final norm in fp32
    assert set(block_dtypes) == {tdtype or torch.float32}
    assert got.dtype == torch.float32
    assert got.shape == (2, SMALL["output_dim"])
    return got.numpy(), want


@pytest.mark.parametrize("attention_style,is_tanh_gating", [
    ("frozen-in-time", False),
    ("frozen-in-time", True),
    ("timesformer-div", False),
    ("frozen-joint", True),
])
def test_timemamba_fp32_matches_jax(gated_params, attention_style,
                                    is_tanh_gating):
    params = gated_params if is_tanh_gating else _ungated(gated_params)
    got, want = _compare(params, _clip(0), attention_style=attention_style,
                         is_tanh_gating=is_tanh_gating)
    np.testing.assert_allclose(got, want, **F32)


def test_timemamba_stacked_tree_matches_jax(gated_params):
    """The stacked tree of scan_blocks=True (how bench.py builds the model)
    carries over as well: the JAX model runs its nn.scan on it."""
    stacked = stack_block_params(gated_params, SMALL["depth"])
    got, want = _compare(stacked, _clip(1), scan_blocks=True,
                         is_tanh_gating=True)
    np.testing.assert_allclose(got, want, **F32)


def test_timemamba_bf16_matches_jax(gated_params):
    got, want = _compare(_ungated(gated_params), _clip(2),
                         jdtype=jnp.bfloat16, tdtype=torch.bfloat16)
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel < BF16_REL, rel


@pytest.mark.parametrize("seed", [0, 3])
def test_mlp_bf16_policy_matches_jax(seed):
    """bf16 Dense layers and GELU as the JAX Mlp computes them; the same
    layer computing in fp32 is the control that must miss."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 40, 32)).astype(np.float32)
    jm = JaxMlp(hidden=128, out=32, dtype=jnp.bfloat16)
    params = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(seed), jnp.asarray(x))["params"])
    want = np.asarray(jm.apply({"params": params},
                               jnp.asarray(x, jnp.bfloat16)), np.float32)
    state = {f"{fc}.{k}": torch.tensor(
                 params[fc][j].T if k == "weight" else params[fc][j])
             for fc in ("fc1", "fc2")
             for k, j in (("weight", "kernel"), ("bias", "bias"))}

    def mean_rel(dtype):
        m = Mlp(32, 128, dtype=dtype, generator=torch.Generator())
        m.load_state_dict(state)
        with torch.no_grad():
            got = m(torch.from_numpy(x).to(dtype or torch.float32))
        assert got.dtype == (dtype or torch.float32)
        return np.abs(got.float().numpy() - want).mean() / np.abs(want).mean()

    assert mean_rel(torch.bfloat16) < MLP_BF16_MEAN_REL
    assert mean_rel(None) > MLP_BF16_MEAN_REL


@pytest.mark.parametrize("dtype", [torch.bfloat16, None])
def test_mlp_gelu_form_matches_jax(dtype):
    """tanh GELU under bf16, exact erf otherwise, as the JAX Mlp picks it.
    Compared in fp32, where the two forms differ by up to 4.7e-4 and the
    two frameworks' same form by 9.5e-7."""
    m = Mlp(8, 16, dtype=dtype, generator=torch.Generator())
    x = np.linspace(-6, 6, 4001, dtype=np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x),
                                  approximate=dtype == torch.bfloat16))
    got = F.gelu(torch.from_numpy(x), approximate=m.approximate).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
