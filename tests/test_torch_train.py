"""The port's train step, optimizer, dropout and drop-path, on the CPU.

The train step of the small TimeMamba of ``test_torch_timemamba.py`` is
held against the JAX model (``impl="assoc"``) under ``jax.value_and_grad``
and ``optax.adamw(1e-4)``, the step of the JAX package's ``bench.py``: the
same numpy clip, target and weights, compared in loss, in each parameter's
gradient and in the parameters after one and after two steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from test_torch_timemamba import SMALL, _clip
from video_mamba_suite_tpu.models.timemamba import TimeMamba as JaxTimeMamba
from video_mamba_suite_tpu.utils.optim import make_optimizer as jax_optimizer
from video_mamba_suite_tpu.utils.optim import (
    no_weight_decay_mask as jax_decay_mask,
)
from video_mamba_suite_torch import make_optimizer, train_step
from video_mamba_suite_torch.models import (
    SpaceTimeBlock,
    TimeMamba,
    timemamba_from_jax,
)
from video_mamba_suite_torch.models.common import dropout
from video_mamba_suite_torch.utils import no_weight_decay_mask


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


LR = 1e-4
# Readings over two steps: loss 3.6e-7 apart (relative 3.1e-7); every
# gradient within 4.0e-6 of its parameter's largest gradient. Parameters
# after AdamW: within 5.7e-7 where some step's JAX gradient exceeds 1e-7.
# Below that the gradient is rounding noise (the attention's key bias has
# none in exact arithmetic) and Adam's normalisation turns noise of either
# sign into a step of up to lr, so there only the step's size is held.
LOSS_RTOL = 1e-5
GRAD_REL = 5e-5
PARAM_ATOL = 2e-6
GRAD_NOISE = 1e-7


def _jax_params(seed=3):
    """The small model's JAX tree (unrolled, tanh gates moved off 0)."""
    model = JaxTimeMamba(**SMALL, is_tanh_gating=True, impl="assoc")
    params = jax.jit(model.init)({"params": jax.random.PRNGKey(seed)},
                                 jnp.zeros((1, 8, 32, 32, 3)))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    for i in range(SMALL["depth"]):
        params[f"block{i}"]["alpha_timeattn"] = np.float32(0.7)
    return params


def _as_state(tree):
    return timemamba_from_jax(
        {"params": jax.tree_util.tree_map(np.asarray, tree)}, SMALL["depth"])


def test_train_steps_match_jax_adamw():
    params = _jax_params()
    model = JaxTimeMamba(**SMALL, is_tanh_gating=True, impl="assoc")
    tx = optax.adamw(LR)

    @jax.jit
    def jax_step(p, state, x, y):
        def loss_fn(p):
            out = model.apply({"params": p}, x).astype(jnp.float32)
            return jnp.mean((out - y) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, state = tx.update(grads, state, p)
        return optax.apply_updates(p, updates), state, loss, grads

    tm = TimeMamba(**SMALL, is_tanh_gating=True, device="cpu")
    tm.load_state_dict(_as_state(params), strict=True)
    opt = make_optimizer(tm, "adamw", lr=LR, weight_decay=1e-4)
    x = _clip(4)
    y = np.random.default_rng(5).standard_normal(
        (2, SMALL["output_dim"])).astype(np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = tx.init(jp)
    big = {}
    for _ in range(2):
        jp, jstate, jloss, jgrads = jax_step(jp, jstate, jnp.asarray(x),
                                             jnp.asarray(y))
        loss = train_step(tm, opt, torch.from_numpy(x), torch.from_numpy(y))
        np.testing.assert_allclose(loss.item(), float(jloss),
                                   rtol=LOSS_RTOL)
        want_g, want_p = _as_state(jgrads), _as_state(jp)
        for name, p in tm.named_parameters():
            scale = want_g[name].abs().max().item()
            err = (p.grad - want_g[name]).abs().max().item()
            assert err <= GRAD_REL * scale + 1e-12, (name, err, scale)
            g_abs = want_g[name].abs()
            big[name] = torch.maximum(big[name], g_abs) if name in big \
                else g_abs
            diff = (p.detach() - want_p[name]).abs()
            signal = big[name] > GRAD_NOISE
            if signal.any():
                assert diff[signal].max().item() <= PARAM_ATOL, name
            assert diff.max().item() <= 2.5 * LR, name


def test_bf16_train_step_is_finite_with_fp32_gradients():
    tm = TimeMamba(**SMALL, dtype=torch.bfloat16, device="cpu", seed=2)
    opt = make_optimizer(tm, "adamw", lr=LR, weight_decay=1e-4)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 8, 32, 32, 3, generator=g).to(torch.bfloat16)
    y = torch.randn(2, SMALL["output_dim"], generator=g)
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    loss = train_step(tm, opt, x, y)
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    for name, p in tm.named_parameters():
        assert p.dtype == torch.float32, name
        assert p.grad is not None and p.grad.dtype == torch.float32, name
        assert torch.isfinite(p.grad).all(), name
        assert not torch.equal(p.detach(), before[name]), name
    for blk in tm.blocks:
        assert blk.time_mamba.fwd.A_log.grad.abs().sum() > 0


# ---------------------------------------------------------------------------
# dropout and drop-path


def test_dropout_is_identity_in_eval_and_at_rate_zero():
    x = torch.randn(4, 8)
    assert dropout(x, 0.5, False, None) is x
    assert dropout(x, 0.0, True, None) is x
    with pytest.raises(ValueError, match="Generator"):
        dropout(x, 0.5, True, None)


def test_dropout_keeps_and_scales_and_repeats():
    x = torch.randn(200, 50)
    out = dropout(x, 0.3, True, torch.Generator().manual_seed(7))
    kept = out != 0
    torch.testing.assert_close(out[kept], x[kept] / 0.7)
    assert abs(kept.float().mean().item() - 0.7) < 0.02
    again = dropout(x, 0.3, True, torch.Generator().manual_seed(7))
    other = dropout(x, 0.3, True, torch.Generator().manual_seed(8))
    assert torch.equal(out, again) and not torch.equal(out, other)


def _model(**kw):
    small = dict(SMALL, depth=3)
    return TimeMamba(**small, **kw, device="cpu", seed=1)


def test_model_dropout_off_in_eval_and_at_rate_zero():
    x = torch.from_numpy(_clip(0))
    plain = _model().eval()
    noisy = _model(drop_rate=0.5, drop_path_rate=0.5).eval()
    with torch.no_grad():
        want = plain(x)
        torch.testing.assert_close(noisy(x), want, atol=0, rtol=0)
        torch.testing.assert_close(plain.train()(x), want, atol=0, rtol=0)
        noisy.train()
        a = noisy(x, generator=torch.Generator().manual_seed(3))
        b = noisy(x, generator=torch.Generator().manual_seed(3))
        c = noisy(x, generator=torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="Generator"):
        noisy(x)


def test_drop_path_schedule_is_linear_in_depth():
    model = _model(drop_path_rate=0.2)
    assert [b.drop_path for b in model.blocks] == pytest.approx(
        [0.0, 0.1, 0.2])
    assert all(b.mlp.drop == 0.0 for b in model.blocks)


class _Const(nn.Module):
    def __init__(self, value):
        super().__init__()
        self.value = value

    def forward(self, x, generator=None):
        return torch.full_like(x, self.value)


def test_drop_path_is_one_decision_per_sample_for_cls_and_patches():
    """With the MLP branch replaced by ones, each sample's cls and patches
    both gain 1 / keep or both gain 0."""
    blk = SpaceTimeBlock(16, 2, drop_path=0.5,
                         generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    cls = torch.randn(64, 1, 16, generator=g)
    patches = torch.randn(64, 3, 4, 16, generator=g)
    with torch.no_grad():
        blk.mlp = _Const(0.0)
        base_cls, base_patches = blk.eval()(cls, patches)
        blk.mlp = _Const(1.0)
        blk.train()
        out = blk(cls, patches, torch.Generator().manual_seed(5))
        again = blk(cls, patches, torch.Generator().manual_seed(5))
    d_cls = (out[0] - base_cls).reshape(64, -1)
    d_patches = (out[1] - base_patches).reshape(64, -1)
    per_sample = d_cls[:, :1]
    torch.testing.assert_close(d_cls, per_sample.expand_as(d_cls))
    torch.testing.assert_close(d_patches, per_sample.expand_as(d_patches))
    values = set(np.round(per_sample.flatten().numpy(), 4).tolist())
    assert values == {0.0, 2.0}                    # 1 / keep, keep = 0.5
    assert torch.equal(out[0], again[0]) and torch.equal(out[1], again[1])


# ---------------------------------------------------------------------------
# the optimizer


def test_decay_groups_match_jax_mask():
    params = _jax_params()
    mask = jax_decay_mask(params)
    as_arrays = jax.tree_util.tree_map(
        lambda m, p: np.full(np.shape(p), float(m)), mask, params)
    want = {n for n, t in _as_state(as_arrays).items() if bool(t.all())}
    assert all(bool(t.all()) or not bool(t.any())
               for t in _as_state(as_arrays).values())
    tm = TimeMamba(**SMALL, is_tanh_gating=True, device="cpu")
    got = no_weight_decay_mask(tm)
    assert {n for n, decay in got.items() if decay} == want
    opt = make_optimizer(tm, "adamw", lr=LR, weight_decay=0.05,
                         use_mask=True)
    names = {id(p): n for n, p in tm.named_parameters()}
    decayed = {names[id(p)] for grp in opt.param_groups
               if grp["weight_decay"] for p in grp["params"]}
    assert decayed == want


class _Leaves(nn.Module):
    """Parameters whose names are JAX leaf names: a matrix that decays and
    three the no-decay rule exempts."""

    def __init__(self, arrays):
        super().__init__()
        for name, a in arrays.items():
            self.register_parameter(name, nn.Parameter(torch.tensor(a)))


@pytest.mark.parametrize("name,kw", [
    ("adamw", dict(weight_decay=0.05)),
    ("adamw", dict(weight_decay=0.05, use_mask=True)),
    ("adamw", dict(weight_decay=0.0, grad_clip=0.5)),
    ("adam", dict(weight_decay=0.05)),
    ("sgd", dict(weight_decay=0.05, momentum=0.9)),
])
def test_optimizer_matches_optax(name, kw):
    rng = np.random.default_rng(0)
    arrays = {"w": rng.standard_normal((3, 4)).astype(np.float32),
              "bias": rng.standard_normal(4).astype(np.float32),
              "A_log": rng.standard_normal((3, 2)).astype(np.float32),
              "D": rng.standard_normal(3).astype(np.float32)}
    grads = [{k: (2 * rng.standard_normal(v.shape)).astype(np.float32)
              for k, v in arrays.items()} for _ in range(3)]
    use_mask = kw.pop("use_mask", False)
    tx = jax_optimizer(name, lr=0.01, **kw,
                       params_for_mask=arrays if use_mask else None)
    module = _Leaves(arrays)
    opt = make_optimizer(module, name, lr=0.01, **kw, use_mask=use_mask)
    jp = {k: jnp.asarray(v) for k, v in arrays.items()}
    state = tx.init(jp)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in module.named_parameters():
            p.grad = torch.tensor(g[k])
        opt.step()
        for k, p in module.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                       atol=1e-6, rtol=1e-6, err_msg=k)
