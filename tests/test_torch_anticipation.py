"""The port's action-anticipation slice against the JAX package's, on the
CPU: ``LSTRMamba`` (forward, heads, streaming), the loss, the trainer's
steps and schedule, ``evaluate`` and the metrics, and ``PerFrameDataset``.

JAX runs ``LSTRMamba(impl="ref")`` (the plain scan); the port runs its
plain versions on the CPU. Weights, features and targets are made by
numpy from a seed; the weights fill the JAX model's tree and reach the
port through ``lstr_mamba_from_jax``. Small widths (features 12 + 6,
d_model 32, 2 layers, 5 classes; 8 + 6 frames and 2 anticipation queries)
keep the file quick.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_mamba_suite_tpu.models.common import (
    sinusoid_positions as jax_positions,
)
from video_mamba_suite_tpu.tasks.anticipation import data as jax_data
from video_mamba_suite_tpu.tasks.anticipation import metrics as jax_metrics
from video_mamba_suite_tpu.tasks.anticipation import model as jax_model
from video_mamba_suite_tpu.tasks.anticipation import train as jax_train
from video_mamba_suite_tpu.utils.schedules import (
    make_schedule as jax_schedule,
)
from video_mamba_suite_torch.models import (
    lstr_mamba_from_jax,
    sinusoid_positions,
)
from video_mamba_suite_torch.ops import LAUNCHES
from video_mamba_suite_torch.tasks.anticipation import (
    AnticipationTrainer,
    LSTRMamba,
    PerFrameDataset,
    anticipation_loss,
    marginalize,
    perframe_average_precision,
    predict,
    topk_recall,
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


SMALL = dict(visual_dim=12, motion_dim=6, d_model=32, num_classes=5,
             long_memory_num_samples=8, work_memory_num_samples=6,
             anticipation_num_samples=2, mamba_layers=2)
# fp32: each output within 2e-5 of its largest magnitude (and 2e-5
# relative); the two frameworks sum in other orders
REL_TOL = 2e-5
# Two train steps, fp32: losses within 5e-6 relative (read 1.1e-7); each
# parameter within 2e-6 (read 4.8e-7) where both steps' gradients exceed
# 1e-4 of that parameter's largest gradient. Adam divides by the
# gradient's square root, so where the gradient is about as small as the
# two frameworks' rounding of it (174 of 21381 values here), the update's
# size (up to the rate) is rounding noise: there the two updates are held
# within twice the rate (read 2.9e-5 at a rate of 1e-3).
LOSS_RTOL = 5e-6
PARAM_ATOL = 2e-6
SMALL_GRAD = 1e-4


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, rel=REL_TOL, msg=""):
    w = _np(want)
    np.testing.assert_allclose(_np(got), w, atol=rel * np.abs(w).max(),
                               rtol=rel, err_msg=msg)


def _features(seed, batch, cfg):
    rng = np.random.default_rng(seed)
    T = cfg["long_memory_num_samples"] + cfg["work_memory_num_samples"]
    visual = rng.standard_normal((batch, T, cfg["visual_dim"]))
    motion = (rng.standard_normal((batch, T, cfg["motion_dim"]))
              if cfg["motion_dim"] else None)
    return (visual.astype(np.float32),
            None if motion is None else motion.astype(np.float32))


def _pair(seed=0, **kw):
    """A JAX LSTRMamba with parameters from ``seed`` and the port's model
    holding the same weights."""
    cfg = dict(SMALL, **kw)
    jm = jax_model.LSTRMamba(**cfg, impl="ref")
    visual, motion = _features(seed, 1, cfg)
    params = _params(jm, seed, visual, motion)
    pm = LSTRMamba(**cfg, device="cpu").eval()
    pm.load_state_dict(lstr_mamba_from_jax(params, cfg["mamba_layers"]))
    return jm, params, pm, cfg


def _params(module, seed, visual, motion):
    """Parameters for the JAX module's tree, drawn by numpy from ``seed``
    in the ranges its init gives (A_log = log of 1..16, small dt, norms
    near 1), as fp32 numpy arrays. The tree's shapes come from
    ``jax.eval_shape``: running flax's init costs seconds of compiling on
    the CPU."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                            jnp.asarray(visual),
                            None if motion is None else jnp.asarray(motion))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "A_log":
            x = np.log(rng.uniform(1.0, 16.0, shape))
        elif name == "dt_bias":            # softplus of it in (0.01, 0.1)
            x = np.log(np.expm1(rng.uniform(0.01, 0.1, shape)))
        elif name in ("norm_w", "norm_f_w"):
            x = 1.0 + 0.1 * rng.standard_normal(shape)
        elif len(shape) == 1:
            x = 0.5 * rng.standard_normal(shape)
        else:                              # flax kernels are (in, out)
            x = rng.standard_normal(shape) / np.sqrt(shape[0])
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)
def _jit(module, method):
    """``module.apply`` of ``method``, compiled (eager flax dispatches op by
    op, compiling each on the CPU)."""
    return jax.jit(functools.partial(module.apply, method=method))


def test_sinusoid_positions_match_jax():
    np.testing.assert_allclose(_np(sinusoid_positions(37, 16)),
                               _np(jax_positions(37, 16)), atol=1e-6)


@pytest.mark.parametrize("kw", [
    dict(anticipation_num_samples=0),
    dict(fc_norm=True, num_verbs=3, num_nouns=4),
    dict(motion_dim=0, long_memory_num_samples=0),
], ids=["ant0", "fc_norm-verb-noun", "visual-only"])
def test_forward_matches_jax(kw):
    """Scores of every head at the work and anticipation positions; the
    CPU runs no kernel."""
    jm, params, pm, cfg = _pair(1, **kw)
    visual, motion = _features(2, 3, cfg)
    want = jax.jit(jm.apply)(params, jnp.asarray(visual),
                             None if motion is None else jnp.asarray(motion))
    before = dict(LAUNCHES)
    with torch.no_grad():
        got = pm(torch.from_numpy(visual),
                 None if motion is None else torch.from_numpy(motion))
    assert dict(LAUNCHES) == before
    assert set(got) == set(want)
    positions = cfg["work_memory_num_samples"] + \
        cfg["anticipation_num_samples"]
    for key, w in want.items():
        assert got[key].shape[:2] == (3, positions), key
        _close(got[key], w, msg=key)


def test_streaming_matches_jax_and_the_forward():
    """``stream_step`` over work tokens (each with its sinusoid position)
    gives the forward's scores; ``stream_prefill`` gives the step loop's
    scores and states; both match the JAX streaming API, and a step after
    the prefill continues as after the loop."""
    cfg = dict(visual_dim=8, motion_dim=0, d_model=16, num_classes=3,
               long_memory_num_samples=0, work_memory_num_samples=5,
               anticipation_num_samples=0, mamba_layers=2)
    jm = jax_model.LSTRMamba(**cfg, impl="ref")
    visual = np.random.default_rng(3).standard_normal((2, 5, 8)).astype(
        np.float32)
    params = _params(jm, 3, visual, None)
    pm = LSTRMamba(**cfg, device="cpu").eval()
    pm.load_state_dict(lstr_mamba_from_jax(params, 2))
    v = torch.from_numpy(visual)
    pe = sinusoid_positions(5, 16)
    with torch.no_grad():
        full = pm(v)["score"]
        toks = torch.stack([pm.embed_work_token(v[:, t]) for t in range(5)],
                           dim=1)
        states = pm.init_stream(2)
        stepped, pe_stepped = [], []
        pe_states = pm.init_stream(2)
        for t in range(5):
            logits, states = pm.stream_step(toks[:, t], states)
            stepped.append(logits)
            logits, pe_states = pm.stream_step(toks[:, t] + pe[t], pe_states)
            pe_stepped.append(logits)
        scores, pre_states = pm.stream_prefill(toks)
        nxt = torch.from_numpy(np.random.default_rng(4).standard_normal(
            (2, 16)).astype(np.float32))
        after_pre, _ = pm.stream_step(nxt, pre_states)
        after_loop, _ = pm.stream_step(nxt, states)
    _close(torch.stack(pe_stepped, 1), full)
    _close(scores, torch.stack(stepped, 1))
    for (c1, s1), (c2, s2) in zip(pre_states, states):
        _close(c1, c2)
        _close(s1, s2)
    _close(after_pre, after_loop)
    # against the JAX streaming API
    jtoks = _jit(jm, "embed_work_token")(params, jnp.asarray(visual[:, 0]))
    _close(toks[:, 0], jtoks)
    want_scores, want_states = _jit(jm, "stream_prefill")(
        params, jnp.asarray(toks.numpy()))
    _close(scores, want_scores)
    for (c1, s1), (c2, s2) in zip(pre_states, want_states):
        _close(c1, c2)
        _close(s1, s2)
    want_step, _ = _jit(jm, "stream_step")(params, jnp.asarray(nxt.numpy()),
                                           want_states)
    _close(after_pre, want_step)


def test_loss_matches_jax_with_ignored_targets():
    rng = np.random.default_rng(5)
    scores = rng.standard_normal((3, 8, 5)).astype(np.float32)
    targets = rng.integers(0, 5, (3, 8)).astype(np.int32)
    targets[0, :3] = -100
    targets[2, 5] = -100
    want = jax_train.anticipation_loss(jnp.asarray(scores),
                                       jnp.asarray(targets))
    got = anticipation_loss(torch.from_numpy(scores),
                            torch.from_numpy(targets))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    # every target ignored: 0, as the JAX loss
    none = np.full_like(targets, -100)
    assert float(anticipation_loss(torch.from_numpy(scores),
                                   torch.from_numpy(none))) == 0.0


def _port_names(params):
    return lstr_mamba_from_jax(jax.tree_util.tree_map(np.asarray, params),
                               SMALL["mamba_layers"])


def test_two_train_steps_match_jax_trainer():
    """Losses and every parameter after each of two steps (dropout off), and
    the schedule's rate at steps 0-2: a warmup of one step, so the first
    step moves no parameter and the second does."""
    kw = dict(lr=1e-3, weight_decay=5e-5, warmup_steps=1, total_steps=10,
              seed=0)
    cfg = dict(SMALL, dropout_cls=0.0)
    jt = jax_train.AnticipationTrainer(
        jax_model.LSTRMamba(**cfg, impl="ref"), **kw)
    visual, motion = _features(6, 3, cfg)
    jt.params = _params(jt.model, 0, visual, motion)
    jt.opt_state = jt.tx.init(jt.params)
    model = LSTRMamba(**cfg, device="cpu")
    model.load_state_dict(_port_names(jt.params))
    pt = AnticipationTrainer(model, **kw)
    want_sched = jax_schedule("cosine", 1e-3, 10, 1)
    for step in range(3):
        np.testing.assert_allclose(pt.schedule(step),
                                   float(want_sched(step)), rtol=1e-6,
                                   atol=1e-12)
    targets = np.random.default_rng(7).integers(0, 5, (3, 8)).astype(
        np.int32)
    targets[1, 2] = -100
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    smallest = {}
    for step in range(2):
        assert pt.optimizer.param_groups[0]["lr"] == pytest.approx(
            pt.schedule(step))
        want_loss = jt.train_step(jnp.asarray(visual), jnp.asarray(motion),
                                  jnp.asarray(targets))
        got_loss = pt.train_step(visual, motion, targets)
        np.testing.assert_allclose(got_loss, want_loss, rtol=LOSS_RTOL)
        want = _port_names(jt.params)
        for name, p in model.named_parameters():
            g = _np(p.grad.abs())
            smallest[name] = np.minimum(smallest.get(name, g), g)
            clear = smallest[name] > SMALL_GRAD * g.max()
            diff = np.abs(_np(p) - _np(want[name]))
            assert (diff[clear] <= PARAM_ATOL).all(), (step, name)
            assert (diff <= 2 * pt.schedule(step)).all(), (step, name)
            if step == 0:       # the schedule's first rate is 0
                torch.testing.assert_close(p.detach(), start[name], atol=0,
                                           rtol=0)
    moved = [n for n, p in model.named_parameters()
             if not torch.equal(p, start[n])]
    assert len(moved) == len(start)
    # evaluate and predict against the JAX trainer's
    got_eval = pt.evaluate(visual, motion, targets)
    want_eval = jt.evaluate(jnp.asarray(visual), jnp.asarray(motion),
                            targets)
    assert set(got_eval) == {"mean_AP", "recall@5"}
    for key, w in want_eval.items():
        np.testing.assert_allclose(got_eval[key], w, rtol=1e-6, err_msg=key)
    probs = predict(model, visual, motion)
    assert model.training              # the flag is restored
    _close(probs, jt._predict(jt.params, jnp.asarray(visual),
                              jnp.asarray(motion)))


def test_dropout_masks_come_from_the_generator():
    """``dropout_cls`` in training mode: the same generator state gives the
    same mask, another state another one, no generator raises; in eval
    mode nothing is dropped."""
    cfg = dict(SMALL, dropout_cls=0.5, anticipation_num_samples=0)
    model = LSTRMamba(**cfg, device="cpu",
                      generator=torch.Generator().manual_seed(8))
    visual, motion = (torch.from_numpy(a) for a in _features(8, 2, cfg))
    model.train()
    with torch.no_grad():
        a = model(visual, motion, generator=torch.Generator().manual_seed(1))
        b = model(visual, motion, generator=torch.Generator().manual_seed(1))
        c = model(visual, motion, generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(a["score"], b["score"], atol=0, rtol=0)
    assert not torch.equal(a["score"], c["score"])
    with pytest.raises(ValueError, match="Generator"):
        model(visual, motion)
    model.eval()
    with torch.no_grad():
        plain = model(visual, motion)["score"]
        d = model(visual, motion, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(plain, d["score"], atol=0, rtol=0)


def test_metrics_match_jax():
    rng = np.random.default_rng(10)
    scores = rng.random((40, 6)).astype(np.float32)
    labels = rng.integers(0, 6, 40)
    labels[:3] = 0
    for ignore in (0, None):
        got = perframe_average_precision(scores, labels, ignore_index=ignore)
        want = jax_metrics.perframe_average_precision(scores, labels,
                                                      ignore_index=ignore)
        assert got["per_class_AP"] == pytest.approx(want["per_class_AP"])
        assert got["mean_AP"] == pytest.approx(want["mean_AP"])
    for k in (1, 3, 5):
        assert topk_recall(scores, labels, k) == pytest.approx(
            jax_metrics.topk_recall(scores, labels, k))
    a2g = rng.integers(0, 3, 6)
    np.testing.assert_allclose(marginalize(scores, a2g, 3),
                               jax_metrics.marginalize(scores, a2g, 3))


def test_dataset_windows_and_batches_match_jax(tmp_path):
    """Windows and shuffled batches over tiny ``.npy`` sessions (one with
    one-hot targets, one too short for a window), as the JAX dataset cuts
    and orders them."""
    rng = np.random.default_rng(11)
    dirs = {k: tmp_path / k for k in ("visual", "motion", "target")}
    for d in dirs.values():
        d.mkdir()
    for name, T in (("s0", 23), ("s1", 17), ("s2", 9)):
        np.save(dirs["visual"] / f"{name}.npy",
                rng.standard_normal((T, 4)).astype(np.float32))
        np.save(dirs["motion"] / f"{name}.npy",
                rng.standard_normal((T, 3)).astype(np.float32))
        tgt = rng.integers(0, 5, T)
        np.save(dirs["target"] / f"{name}.npy",
                np.eye(5)[tgt] if name == "s1" else tgt)
    for motion_dir in (str(dirs["motion"]), None):
        kw = dict(sessions=["s0", "s1", "s2"], visual_dir=str(dirs["visual"]),
                  motion_dir=motion_dir, target_dir=str(dirs["target"]),
                  long_memory=4, work_memory=3, anticipation=2, stride=2,
                  seed=3)
        got, want = PerFrameDataset(**kw), jax_data.PerFrameDataset(**kw)
        assert got.windows == want.windows and len(got) > 0
        for i in (0, len(got) - 1):
            for g, w in zip(got[i], want[i]):
                np.testing.assert_array_equal(g, w)
        for shuffle in (True, False):
            pairs = list(zip(got.batches(3, shuffle), want.batches(3,
                                                                  shuffle)))
            assert len(pairs) == len(got) // 3
            for gb, wb in pairs:
                for g, w in zip(gb, wb):
                    assert g.dtype == w.dtype
                    np.testing.assert_array_equal(g, w)
