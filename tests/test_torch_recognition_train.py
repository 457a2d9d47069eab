"""The port's recognition trainer against the JAX package's, on the CPU.

Each piece of ``RecognitionTrainer`` is held against its JAX counterpart
from the same numpy inputs: the soft-target cross-entropy, label
smoothing, the mixup / cutmix apply fed the JAX draw, the schedules, the
plateau scaler, the EMA, the layer-decay factors and the no-decay mask
(through ``vivim_from_jax``'s names), and the optax chain clip → layer
decay → AdamW with an eps large enough that scaling the gradients before
Adam shows. Then three ``train_step``s of a small ViViM (4 frames of 64²
at patch 16: 4 x 17 = 68 tokens, so the long route of one chunked scan
per direction; depth 2, width 32) against the JAX trainer's, in loss,
parameters and EMA after each step.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from video_mamba_suite_tpu.models.vivim import ViViM as JaxViViM
from video_mamba_suite_tpu.tasks.recognition import augment as jax_augment
from video_mamba_suite_tpu.tasks.recognition import optim as jax_optim
from video_mamba_suite_tpu.tasks.recognition import train as jax_train
from video_mamba_suite_tpu.utils import ema as jax_ema
from video_mamba_suite_tpu.utils import schedules as jax_schedules
from video_mamba_suite_tpu.utils.optim import (
    no_weight_decay_mask as jax_decay_mask,
)
from video_mamba_suite_torch.configs import VIVIM_T_K400_FINETUNE
from video_mamba_suite_torch.models import ViViM, vivim_from_jax
from video_mamba_suite_torch.tasks.recognition import (
    MixDraw,
    RecognitionTrainer,
    apply_mixup_cutmix,
    draw_mixup_cutmix,
    layer_decay_param_groups,
    one_hot_smooth,
    soft_target_cross_entropy,
)
from video_mamba_suite_torch.utils import (
    ModelEma,
    ReduceLROnPlateau,
    chain_step,
    lambda_lr,
    make_optimizer,
    make_schedule,
    no_weight_decay_mask,
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


SMALL = dict(img_size=64, patch_size=16, num_frames=4, depth=2,
             embed_dim=32, num_classes=5, drop_path_rate=0.0)
# Readings over three steps: losses within 5.4e-7 relative, every
# parameter and every EMA value within 4.8e-7 (fp32; the two frameworks
# sum in other orders, and Adam divides by the gradients' square roots).
LOSS_RTOL = 5e-6
PARAM_ATOL = 2e-6


def _videos(seed, n=3):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, 4, 64, 64, 3)).astype(np.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _port_names(tree, depth=2):
    """A JAX ViViM tree of per-leaf arrays → the port's names."""
    return vivim_from_jax(jax.tree_util.tree_map(np.asarray, tree), depth)


def test_soft_target_cross_entropy_and_smoothing_match_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((6, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, 6)
    for smoothing in (0.0, 0.1):
        want_t = jax_augment.one_hot_smooth(jnp.asarray(labels), 11,
                                            smoothing)
        got_t = one_hot_smooth(torch.from_numpy(labels), 11, smoothing)
        np.testing.assert_allclose(_np(got_t), _np(want_t), atol=1e-7)
        want = jax_train.soft_target_cross_entropy(jnp.asarray(logits),
                                                   want_t)
        got = soft_target_cross_entropy(torch.from_numpy(logits), got_t)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def _jax_draw(key, H, W, mixup_alpha, cutmix_alpha, switch_prob=0.5):
    """The random numbers the JAX mixup_cutmix draws from ``key``
    (augment.py:39-52)."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    return MixDraw(
        float(jax.random.beta(k1, mixup_alpha, mixup_alpha)),
        float(jax.random.beta(k2, cutmix_alpha, cutmix_alpha)),
        bool(jax.random.uniform(k3) < switch_prob),
        int(jax.random.randint(k4, (), 0, H)),
        int(jax.random.randint(k4, (), 0, W)))


def test_mixup_cutmix_apply_matches_jax_on_its_draws():
    """Fed the JAX draw, the port's apply gives the JAX videos and soft
    targets, in the mixup branch and in the cutmix branch (keys chosen
    until both were seen, on a non-square frame)."""
    rng = np.random.default_rng(1)
    videos = rng.standard_normal((4, 2, 12, 10, 3)).astype(np.float32)
    labels = np.array([0, 3, 1, 3])
    seen = set()
    for seed in range(40):
        key = jax.random.PRNGKey(seed)
        draw = _jax_draw(key, 12, 10, 0.8, 1.0)
        if draw.use_cutmix in seen:
            continue
        seen.add(draw.use_cutmix)
        want_v, want_t = jax_augment.mixup_cutmix(
            key, jnp.asarray(videos), jnp.asarray(labels), 5, 0.8, 1.0,
            smoothing=0.1)
        got_v, got_t = apply_mixup_cutmix(
            torch.from_numpy(videos), torch.from_numpy(labels), 5, draw,
            smoothing=0.1)
        np.testing.assert_allclose(_np(got_v), _np(want_v), atol=1e-6)
        np.testing.assert_allclose(_np(got_t), _np(want_t), atol=1e-6)
        if len(seen) == 2:
            break
    assert seen == {False, True}


def test_mixup_cutmix_draw_keeps_the_jax_quirks():
    """cy == cx on square frames (one key for both, as the JAX draw);
    λ in (0, 1); both branches occur; one alpha at 0 is refused."""
    g = torch.Generator().manual_seed(0)
    draws = [draw_mixup_cutmix(g, 16, 16) for _ in range(64)]
    assert all(d.cy == d.cx and 0 <= d.cy < 16 for d in draws)
    assert all(0 < d.lam_mix < 1 and 0 < d.lam_cut < 1 for d in draws)
    assert {d.use_cutmix for d in draws} == {False, True}
    mean = np.mean([d.lam_mix for d in draws])
    assert 0.35 < mean < 0.65                 # Beta(0.8, 0.8) has mean 1/2
    with pytest.raises(ValueError, match="alphas"):
        draw_mixup_cutmix(g, 16, 16, mixup_alpha=0.0)


@pytest.mark.parametrize("name,warmup,kw", [
    ("cosine", 3, {}),
    ("cosine", 0, {"min_lr": 1e-5}),
    ("multistep", 2, {"milestones": [3, 6], "gamma": 0.5}),
    ("multistep", 0, {"milestones": [4]}),
    ("linear", 2, {"min_lr": 1e-4}),
    ("linear", 0, {}),
    ("constant", 3, {}),
    ("constant", 0, {}),
])
def test_schedules_match_optax(name, warmup, kw):
    total = 10
    want = jax_schedules.make_schedule(name, 1e-3, total, warmup, **kw)
    got = make_schedule(name, 1e-3, total, warmup, **kw)
    for step in range(total + 3):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6,
                                   atol=1e-12, err_msg=f"step {step}")


def test_lambda_lr_runs_step_k_at_schedule_k():
    """optax reads the schedule at the update's count from 0: the first
    step runs at schedule(0), which is 0 with a warmup."""
    sched = make_schedule("cosine", 1e-3, 10, 3)
    p = torch.nn.Parameter(torch.ones(3))
    opt = torch.optim.AdamW([p], lr=1.0)
    lr = lambda_lr(opt, sched)
    for step in range(6):
        assert opt.param_groups[0]["lr"] == pytest.approx(sched(step))
        p.grad = torch.ones(3)
        opt.step()
        lr.step()
    assert sched(0) == 0.0


def test_reduce_on_plateau_matches_jax():
    metrics = [1.0, 0.9, 0.95, 0.93, 0.92, 0.91, 0.97, 0.8, 0.85, 0.86,
               0.87, 0.88]
    for mode in ("min", "max"):
        want = jax_schedules.ReduceLROnPlateau(0.5, 2, mode)
        got = ReduceLROnPlateau(0.5, 2, mode)
        assert [got.step(m) for m in metrics] == \
            [want.step(m) for m in metrics]


@functools.lru_cache(maxsize=None)
def _jax_small(seed=0, mixer="vim"):
    """A small JAX ViViM and its initial parameters as numpy arrays, one
    compiled init per (seed, mixer) for the file (the tests read them and
    build new trees from them)."""
    model = JaxViViM(**SMALL, mixer=mixer)
    params = jax.jit(model.init)(jax.random.PRNGKey(seed),
                                 jnp.asarray(_videos(0)[:1]))
    return model, jax.tree_util.tree_map(np.asarray, params)


def _port_small(params, mixer="vim"):
    model = ViViM(**SMALL, mixer=mixer, device="cpu")
    model.load_state_dict(_port_names(params), strict=True)
    return model


def test_ema_matches_jax():
    _, params = _jax_small()
    model = _port_small(params)
    ema, state = ModelEma(model, 0.9), jax_ema.ema_init(params, 0.9)
    rng = np.random.default_rng(2)
    for _ in range(3):
        params = jax.tree_util.tree_map(
            lambda p: p + rng.standard_normal(p.shape).astype(np.float32),
            params)
        model.load_state_dict(_port_names(params))
        ema.update(model)
        state = jax_ema.ema_update(state, params)
    want = _port_names(state.params)
    for name, e in ema.state_dict().items():
        np.testing.assert_allclose(_np(e), _np(want[name]), atol=1e-6,
                                   err_msg=name)


def test_layer_decay_and_decay_mask_match_jax():
    """The port's layer ids give every counterpart parameter the JAX
    factor, and its no-decay rule the JAX mask."""
    _, params = _jax_small()
    model = _port_small(params)
    scales = jax_optim.layer_decay_param_groups(params, 2, 0.75)
    want = _port_names(jax.tree_util.tree_map(
        lambda p, s: np.full(p.shape, s, np.float32), params, scales))
    got = layer_decay_param_groups(model, 2, 0.75)
    assert set(got) == set(want)
    for name, w in want.items():
        assert np.unique(_np(w)).tolist() == \
            [pytest.approx(got[name], rel=1e-6)], name
    assert sorted(set(np.round(list(got.values()), 6))) == \
        sorted({round(0.75 ** k, 6) for k in (0, 1, 2, 3)})
    mask = _port_names(jax.tree_util.tree_map(
        lambda p, m: np.full(p.shape, float(m), np.float32), params,
        jax_decay_mask(params)))
    got_mask = no_weight_decay_mask(model)
    for name, w in mask.items():
        assert got_mask[name] == bool(_np(w).flat[0]), name


def _optax_chain(params, sched, eps, layer_decay=0.75):
    return optax.chain(
        optax.clip_by_global_norm(1.0),
        jax_optim.scale_by_layer_decay(params, 2, layer_decay),
        optax.adamw(sched, eps=eps, weight_decay=0.05,
                    mask=jax_decay_mask(params)))


def _port_chain_run(params, grads_seq, eps, scales):
    model = _port_small(params)
    opt = make_optimizer(model, "adamw", lr=1e-3, weight_decay=0.05,
                         eps=eps, use_mask=True)
    lr = lambda_lr(opt, make_schedule("cosine", 1e-3, 10, 1))
    for grads in grads_seq:
        port_grads = _port_names(grads)
        for name, p in model.named_parameters():
            p.grad = port_grads[name].clone()
        chain_step(opt, model.named_parameters(), scales, 1.0)
        lr.step()
    return {n: p.detach() for n, p in model.named_parameters()}


def test_chain_matches_optax_with_visible_layer_decay():
    """clip → layer-decay scale → AdamW against the optax chain over three
    updates of random gradients (global norm above 1, so the clip acts).
    eps = 1e-2 is of the gradients' size, so Adam no longer cancels the
    layer-decay scale: a chain without it misses by far more than the
    tolerance, which the last assertion shows."""
    _, params = _jax_small()
    rng = np.random.default_rng(5)
    grads_seq = [jax.tree_util.tree_map(
        lambda p: (0.02 * rng.standard_normal(p.shape)).astype(np.float32),
        params) for _ in range(3)]
    eps = 1e-2
    sched = jax_schedules.make_schedule("cosine", 1e-3, 10, 1)
    tx = _optax_chain(params, sched, eps)
    state, jparams = tx.init(params), params
    for grads in grads_seq:
        updates, state = tx.update(grads, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
    want = _port_names(jparams)
    model = _port_small(params)
    scales = layer_decay_param_groups(model, 2, 0.75)
    got = _port_chain_run(params, grads_seq, eps, scales)
    worst = 0.0
    for name, w in want.items():
        np.testing.assert_allclose(_np(got[name]), _np(w), atol=1e-7,
                                   rtol=1e-6, err_msg=name)
    unscaled = _port_chain_run(params, grads_seq, eps, {})
    for name, w in want.items():
        worst = max(worst, float(np.abs(_np(unscaled[name]) - _np(w)).max()))
    assert worst > 1e-5, worst


def _trainer_pair(ema_decay=0.5):
    kw = dict(lr=1e-3, weight_decay=0.05, layer_decay=0.75, warmup_steps=1,
              total_steps=10, mixup_alpha=0.0, cutmix_alpha=0.0,
              smoothing=0.1, ema_decay=ema_decay, seed=0)
    jt = jax_train.RecognitionTrainer(JaxViViM(**SMALL), 5, **kw)
    jt.init(jnp.asarray(_videos(0)[:1]))
    model = _port_small(jax.tree_util.tree_map(np.asarray, jt.params))
    return jt, RecognitionTrainer(model, 5, **kw)


def test_three_train_steps_match_jax_trainer():
    """Losses, parameters and EMA after each of three steps (mixup and
    drop-path off, so no random numbers are drawn; warmup of one step, so
    the first step moves no parameter and the next two do)."""
    jt, pt = _trainer_pair()
    labels = np.array([1, 4, 2])
    start = {n: p.detach().clone() for n, p in pt.model.named_parameters()}
    for step in range(3):
        videos = _videos(10 + step)
        want_loss = jt.train_step(jnp.asarray(videos), jnp.asarray(labels))
        got_loss = pt.train_step(videos, labels)
        np.testing.assert_allclose(got_loss, want_loss, rtol=LOSS_RTOL)
        want = _port_names(jt.params)
        want_ema = _port_names(jt.ema.params)
        got_ema = pt.ema.state_dict()
        for name, p in pt.model.named_parameters():
            np.testing.assert_allclose(_np(p), _np(want[name]),
                                       atol=PARAM_ATOL,
                                       err_msg=f"step {step} {name}")
            np.testing.assert_allclose(_np(got_ema[name]),
                                       _np(want_ema[name]), atol=PARAM_ATOL,
                                       err_msg=f"step {step} EMA {name}")
        if step == 0:      # the schedule's first rate is 0
            for name, p in pt.model.named_parameters():
                torch.testing.assert_close(p.detach(), start[name],
                                           atol=0, rtol=0)


def test_trainer_state_dict_round_trip():
    pt = RecognitionTrainer(ViViM(**SMALL, device="cpu", seed=2), 5,
                            warmup_steps=1, total_steps=10, ema_decay=0.5)
    videos, labels = _videos(3), np.array([0, 1, 2])
    pt.train_step(videos, labels)
    state = copy.deepcopy(pt.state_dict())
    a = pt.train_step(videos, labels)
    after = {n: p.detach().clone() for n, p in pt.model.named_parameters()}
    pt.load_state_dict(state)
    b = pt.train_step(videos, labels)
    assert a == b
    for name, p in pt.model.named_parameters():
        torch.testing.assert_close(p.detach(), after[name], atol=0, rtol=0)


def test_finetune_preset_matches_the_jax_preset():
    from video_mamba_suite_tpu.configs.presets import PRESETS

    preset = PRESETS["recognition_k400_vivim_tiny"]
    opt, aug = preset["opt"], preset["aug"]
    assert VIVIM_T_K400_FINETUNE == dict(
        lr=opt["learning_rate"], weight_decay=opt["weight_decay"],
        layer_decay=opt["layer_decay"], ema_decay=opt["ema_decay"],
        mixup_alpha=aug["mixup"], cutmix_alpha=aug["cutmix"],
        smoothing=aug["smoothing"])


def test_mixup_in_train_step_uses_the_trainers_generator():
    """With mixup on, two trainers of one seed draw the same numbers and
    give the same loss; another seed draws others."""
    losses = []
    for seed in (0, 0, 1):
        model = ViViM(**SMALL, device="cpu", seed=4)
        tr = RecognitionTrainer(model, 5, warmup_steps=1, total_steps=10,
                                seed=seed)
        losses.append(tr.train_step(_videos(7), np.array([0, 1, 2])))
    assert losses[0] == losses[1] != losses[2]
