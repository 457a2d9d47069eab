"""The port's egocentric training against the JAX package's, on the CPU at
small widths: ``clip_loss`` and ``max_margin_ranking_loss`` with their
gradients, one step of ``MirFinetuner``, ``ClipPretrainer`` and
``ClsFinetuner`` (dropout 0, mixup off), the classifier's mixup on the JAX
draw, its multi-crop and marginalised ``evaluate``, TimeMamba without a
projection, and the builders' recipes. One JAX CLIP-TimeMamba (2 layers,
2 frames of 16², width 32; text 2 layers, vocabulary 50) is shared by
every test, its weights carried over by ``clip_from_jax`` and
``video_classifier_from_jax``."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_recognition_train import _jax_draw
from video_mamba_suite_torch.configs import (
    CLIP_TIMEMAMBA_B_EK100_MIR,
    EGO_EK100_CLS,
    EGO_TIMEMAMBA_PRETRAIN,
)
from video_mamba_suite_torch.models import (
    CLIP,
    TimeMamba,
    clip_from_jax,
    video_classifier_from_jax,
)
from video_mamba_suite_torch.tasks.egocentric import (
    ClipPretrainer,
    ClsFinetuner,
    MirFinetuner,
    build_clip_mir,
    build_clip_pretrainer,
    build_ek100_cls,
    clip_loss,
    max_margin_ranking_loss,
)
from video_mamba_suite_torch.tasks.recognition.train import \
    soft_target_cross_entropy
from video_mamba_suite_tpu.configs.presets import PRESETS
from video_mamba_suite_tpu.models import clip as jclip
from video_mamba_suite_tpu.models.timemamba import TimeMamba as JaxTimeMamba
from video_mamba_suite_tpu.tasks.egocentric import losses as jlosses
from video_mamba_suite_tpu.tasks.egocentric.finetune import \
    ClsFinetuner as JaxClsFinetuner
from video_mamba_suite_tpu.tasks.egocentric.finetune import \
    MirFinetuner as JaxMirFinetuner
from video_mamba_suite_tpu.tasks.egocentric.metrics import \
    get_marginal_indexes
from video_mamba_suite_tpu.tasks.egocentric.train import \
    ClipPretrainer as JaxClipPretrainer
from video_mamba_suite_tpu.tasks.recognition import augment as jaugment


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


TEXT = dict(context_length=8, vocab_size=50, width=32, heads=4, layers=2)
VISION = dict(img_size=16, patch_size=8, embed_dim=32, depth=2,
              num_heads=2, num_frames=2, ln_pre=True,
              attention_style="frozen-in-time", is_tanh_gating=True)
EMBED, CLASSES = 16, 6
LR = 1e-3
# the losses and their gradients: fp32 on both sides
LOSS_TOL = 1e-6
# a step's loss: fp32 forwards through two towers in another order
STEP_RTOL = 1e-5
# every parameter after one step: Adam's first update is close to
# lr · sign(g), so a gradient's rounding moves a parameter by a small
# fraction of lr. Where a gradient is about as small as the two
# frameworks' rounding of it (below 1e-4 of its parameter's largest; read
# 1 of 6144 values of the patch embedding in the MIR step, a gradient of
# 8e-10 against a rounding of 1.8e-8), the update's size is rounding
# noise: there the two updates are held within twice the rate, as the
# anticipation and TAL trainers' tests hold them.
PARAM_ATOL = 1e-5 + 1e-3 * LR
SMALL_GRAD = 1e-4
RECIPE = dict(lr=LR, warmup_steps=0, total_steps=10)


def _np(x):
    return np.asarray(x.detach().float().numpy() if torch.is_tensor(x)
                      else x, np.float32)


def _batch(seed, n=4):
    rng = np.random.default_rng(seed)
    videos = rng.standard_normal((n, 2, 16, 16, 3)).astype(np.float32)
    texts = rng.integers(1, TEXT["vocab_size"],
                         (n, TEXT["context_length"])).astype(np.int32)
    return videos, texts


def _seeded_leaf(path, shape, rng):
    """A weight of the JAX tree's shape drawn from ``rng``: norms' scales
    near 1, the scan's A_log at log(1..N) as initialised, the tanh gates
    at 0.7 (off 0, which would hide the temporal branch), the temperature
    at log(1 / 0.07), other vectors small, matrices at 1/sqrt(fan_in)."""
    name = path[-1]
    noise = rng.standard_normal(shape).astype(np.float32)
    if name == "alpha_timeattn":
        return np.full(shape, 0.7, np.float32)
    if name == "logit_scale":
        return np.full(shape, np.log(1 / 0.07), np.float32)
    if name == "A_log":
        return (np.log(np.arange(1, shape[-1] + 1, dtype=np.float32))
                + 0.1 * noise)
    if name == "scale":
        return 1 + 0.1 * noise
    if len(shape) <= 1:
        return 0.1 * noise
    return noise / np.sqrt(np.prod(shape[:-1]))


def _seeded(tree, rng, path=()):
    if isinstance(tree, dict):
        return {k: _seeded(v, rng, path + (k,)) for k, v in tree.items()}
    return _seeded_leaf(path, tree.shape, rng)


@pytest.fixture(scope="module")
def clip_pair():
    """The JAX CLIP and a parameter tree of its shapes drawn with numpy
    from a seed (its tree from ``eval_shape``: no compiled init)."""
    jm = jclip.CLIP(embed_dim=EMBED, vision_tower="timemamba",
                    vision_cfg=dict(VISION, impl="assoc"), text_cfg=TEXT)
    videos, texts = _batch(0, 1)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.asarray(videos), jnp.asarray(texts))
    return jm, _seeded(shapes, np.random.default_rng(0))


def _port_clip(params):
    model = CLIP(embed_dim=EMBED, vision_tower="timemamba",
                 vision_cfg=VISION, text_cfg=TEXT, device="cpu")
    model.load_state_dict(clip_from_jax(params), strict=True)
    return model


def _assert_params(model, want_tree, convert, label):
    """Every parameter of ``model`` after a step against the converted JAX
    tree: within ``PARAM_ATOL`` where the step's gradient is not below
    ``SMALL_GRAD`` of its parameter's largest, within twice the rate
    elsewhere."""
    want = convert(jax.tree_util.tree_map(np.asarray, want_tree))
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    for name, p in got.items():
        grad = np.abs(_np(p.grad))
        small = grad < SMALL_GRAD * grad.max()
        diff = np.abs(_np(p) - _np(want[name]))
        assert diff[~small].max(initial=0.0) <= PARAM_ATOL, \
            f"{label}: {name} {diff[~small].max()}"
        assert diff[small].max(initial=0.0) <= 2 * LR, \
            f"{label}: {name} at small gradients {diff[small].max()}"


@pytest.mark.parametrize("loss", ["clip", "max_margin"])
def test_losses_and_gradients_match_jax(loss):
    rng = np.random.default_rng(1)
    img = rng.standard_normal((5, 16)).astype(np.float32)
    txt = rng.standard_normal((5, 16)).astype(np.float32)
    img /= np.linalg.norm(img, axis=-1, keepdims=True)
    txt /= np.linalg.norm(txt, axis=-1, keepdims=True)
    scale = np.float32(1 / 0.07)
    if loss == "clip":
        jfn = jlosses.clip_loss
        pfn = clip_loss
        args = (img, txt, scale)
    else:
        def jfn(a, b):
            return jlosses.max_margin_ranking_loss(b @ a.T, margin=0.2)

        def pfn(a, b):
            return max_margin_ranking_loss(b @ a.T, margin=0.2)
        args = (img, txt)
    want, want_grads = jax.jit(jax.value_and_grad(
        jfn, argnums=tuple(range(len(args)))))(*map(jnp.asarray, args))
    tensors = [torch.tensor(a, requires_grad=True) for a in args]
    got = pfn(*tensors)
    got.backward()
    assert got.item() == pytest.approx(float(want), abs=LOSS_TOL)
    for t, w in zip(tensors, want_grads):
        np.testing.assert_allclose(_np(t.grad), np.asarray(w), rtol=0,
                                   atol=LOSS_TOL)


def test_max_margin_on_one_pair_divides_by_two():
    """n = 1: the only pair is the diagonal, masked; the denominator is
    n · max(n - 1, 1) · 2 = 2."""
    sim = torch.tensor([[0.3]])
    assert float(max_margin_ranking_loss(sim)) == 0.0
    sim = torch.tensor([[0.1, 0.9], [0.4, 0.2]])
    want = jlosses.max_margin_ranking_loss(jnp.asarray(sim.numpy()))
    assert float(max_margin_ranking_loss(sim)) == pytest.approx(
        float(want), abs=LOSS_TOL)


def test_mir_step_matches_jax(clip_pair):
    """One MIR step (max-margin on text x video similarities, AdamW b2
    0.98 at lr, clip 1.0): the loss and every parameter, the temperature's
    zero gradient and weight decay included."""
    jm, params = clip_pair
    videos, texts = _batch(2)
    jt = JaxMirFinetuner(jm, **RECIPE)
    jt.init(None, None, params=params)
    want = jt.train_step(jnp.asarray(videos), jnp.asarray(texts))
    pt = MirFinetuner(_port_clip(params), **RECIPE)
    scale0 = pt.model.logit_scale.detach().clone()
    got = pt.train_step(videos, texts)
    assert got == pytest.approx(want, rel=STEP_RTOL)
    _assert_params(pt.model, jt.params, clip_from_jax, "MIR step")
    assert pt.model.logit_scale.item() == pytest.approx(
        scale0.item() * (1 - LR * 0.01), rel=1e-7)


def test_mir_init_adopts_a_state_and_restarts_the_schedule(clip_pair):
    jm, params = clip_pair
    pt = MirFinetuner(_port_clip(params), **dict(RECIPE, warmup_steps=2))
    videos, texts = _batch(3)
    pt.train_step(videos, texts)
    other = _port_clip(params).state_dict()
    pt.init(other)
    assert pt.lr_scheduler.last_epoch == 0 and not pt.optimizer.state
    for name, value in pt.model.state_dict().items():
        torch.testing.assert_close(value, other[name], rtol=0, atol=0)
    state = copy.deepcopy(pt.state_dict())
    pt.train_step(videos, texts)
    fresh = MirFinetuner(_port_clip(params), **dict(RECIPE, warmup_steps=2))
    fresh.load_state_dict(state)
    fresh.train_step(videos, texts)
    for (name, a), b in zip(pt.model.named_parameters(),
                            fresh.model.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)


def test_pretrain_step_and_encode_match_jax(clip_pair):
    """One CLIP pretraining step (symmetric InfoNCE, the temperature
    learned): the loss and every parameter; then ``encode``: the eval-mode
    embeddings and the learned scale."""
    jm, params = clip_pair
    videos, texts = _batch(4)
    jt = JaxClipPretrainer(jm, **RECIPE)
    jt.params = params
    jt.opt_state = jt.tx.init(params)
    want = jt.train_step(jnp.asarray(videos), jnp.asarray(texts))
    pt = ClipPretrainer(_port_clip(params), **RECIPE)
    got = pt.train_step(videos, texts)
    assert got == pytest.approx(want, rel=STEP_RTOL)
    _assert_params(pt.model, jt.params, clip_from_jax, "pretrain step")
    img, txt, scale = pt.encode(videos, texts)
    assert pt.model.training
    with torch.no_grad():
        want = pt.model.eval()(torch.from_numpy(videos),
                               torch.from_numpy(texts).long())
    np.testing.assert_array_equal(img, _np(want[0]))
    np.testing.assert_array_equal(txt, _np(want[1]))
    assert scale == pytest.approx(float(want[2]), rel=1e-7)
    assert scale == pytest.approx(float(np.exp(np.asarray(
        jt.params["params"]["logit_scale"]))), rel=1e-6)


def _tower_params(params):
    """The CLIP's video tower without its projection: a classifier's."""
    visual = dict(params["params"]["visual"])
    visual.pop("image_projection")
    return visual


@pytest.fixture(scope="module")
def cls_pair(clip_pair):
    """The JAX ClsFinetuner on a TimeMamba without projection, holding the
    CLIP's tower as its ``init(pretrained_visual=...)`` grafts it (the
    tree set directly: JAX's ``init`` runs the model eagerly first) and a
    head drawn from N(0, 0.01²)."""
    _, params = clip_pair
    tower = JaxTimeMamba(**VISION, output_dim=None, impl="assoc")
    jt = JaxClsFinetuner(tower, CLASSES, dropout=0.0, smoothing=0.1,
                         **RECIPE)
    rng = np.random.default_rng(10)
    jt.params = {"params": {
        "vision_tower": _tower_params(params),
        "fc_cls": {"kernel": (0.01 * rng.standard_normal(
            (VISION["embed_dim"], CLASSES))).astype(np.float32),
            "bias": np.zeros(CLASSES, np.float32)}}}
    return jt


def _port_cls(jt, **kw):
    tower = TimeMamba(**VISION, output_dim=None, device="cpu")
    pt = ClsFinetuner(tower, CLASSES, dropout=0.0, smoothing=0.1,
                      **dict(RECIPE, **kw))
    pt.model.load_state_dict(video_classifier_from_jax(jt.params),
                             strict=True)
    return pt


def test_timemamba_without_projection_matches_jax(clip_pair):
    """output_dim None: the normed cls token, embed_dim wide."""
    _, params = clip_pair
    videos, _ = _batch(6)
    tower = JaxTimeMamba(**VISION, output_dim=None, impl="assoc")
    want = jax.jit(tower.apply)({"params": _tower_params(params)},
                                jnp.asarray(videos))
    port = TimeMamba(**VISION, output_dim=None, device="cpu")
    assert port.image_projection is None
    port.load_state_dict({
        k[len("visual."):]: v for k, v in clip_from_jax(params).items()
        if k.startswith("visual.") and k != "visual.image_projection"})
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(videos))
    assert tuple(got.shape) == (len(videos), VISION["embed_dim"])
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(want)).max())


def test_cls_graft_and_step_match_jax(clip_pair, cls_pair):
    """``init(pretrained_visual=...)`` grafts the CLIP's tower (its
    projection dropped) as the JAX init does; one step (smoothing 0.1,
    mixup off) gives the JAX loss and parameters."""
    _, params = clip_pair
    jt = copy.copy(cls_pair)
    jt.opt_state = jt.tx.init(jt.params)
    pt = _port_cls(jt)
    graft = ClsFinetuner(TimeMamba(**VISION, output_dim=None, device="cpu"),
                         CLASSES, dropout=0.0)
    graft.init(pretrained_visual={
        k[len("visual."):]: v for k, v in
        _port_clip(params).state_dict().items() if k.startswith("visual.")})
    for name, value in graft.model.vision_tower.state_dict().items():
        torch.testing.assert_close(
            value, pt.model.vision_tower.state_dict()[name], rtol=0, atol=0)
    videos, _ = _batch(7)
    labels = np.array([0, 5, 2, 2])
    want = jt.train_step(jnp.asarray(videos), jnp.asarray(labels))
    got = pt.train_step(videos, labels)
    assert got == pytest.approx(want, rel=STEP_RTOL)
    _assert_params(pt.model, jt.params, video_classifier_from_jax,
                   "classification step")


@pytest.mark.parametrize("branch,seed", [("mixup", 0), ("cutmix", 3)])
def test_cls_mixup_uses_the_jax_draw(cls_pair, branch, seed):
    """With mixup and cutmix on, a step fed the JAX draw of a key trains on
    the JAX ``mixup_cutmix`` batch and soft targets of that key: its loss
    is the loss of the JAX-mixed batch (key 0 draws mixup, key 3
    cutmix)."""
    videos, _ = _batch(8)
    labels = np.array([1, 3, 3, 0])
    key = jax.random.PRNGKey(seed)
    draw = _jax_draw(key, 16, 16, 0.8, 1.0)
    assert draw.use_cutmix == (branch == "cutmix")
    mixed, targets = jax.jit(jaugment.mixup_cutmix, static_argnums=(3,))(
        key, jnp.asarray(videos), jnp.asarray(labels), CLASSES, 0.8, 1.0,
        smoothing=0.1)
    pt = _port_cls(cls_pair, mixup_alpha=0.8, cutmix_alpha=1.0)
    with torch.no_grad():
        want = soft_target_cross_entropy(
            pt.model.train()(torch.from_numpy(np.array(mixed))),
            torch.from_numpy(np.array(targets)))
    got = pt.train_step(videos, labels, draw=draw)
    assert got == pytest.approx(float(want), rel=STEP_RTOL)


def test_cls_evaluate_matches_jax(cls_pair):
    """Multi-crop clips (the crops' probabilities averaged) with verb and
    noun marginals: the same top-1 / top-5 as the JAX evaluate fed the
    same per-crop probabilities (the port's)."""
    jt = copy.copy(cls_pair)
    pt = _port_cls(jt)
    rng = np.random.default_rng(9)
    videos = rng.standard_normal((5, 2, 2, 16, 16, 3)).astype(np.float32)
    labels = np.array([0, 1, 2, 3, 4])
    to_verb = get_marginal_indexes(np.array([0, 0, 1, 1, 2, 2]), 3)
    to_noun = get_marginal_indexes(np.array([0, 1, 0, 1, 0, 1]), 2)
    jt._predict = lambda params, v: pt.predict(np.asarray(v))
    want = jt.evaluate(videos, labels, batch_size=4, action_to_verb=to_verb,
                       action_to_noun=to_noun)
    got = pt.evaluate(videos, labels, batch_size=4, action_to_verb=to_verb,
                      action_to_noun=to_noun)
    assert set(got) == set(want) and len(got) == 6
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-9), k
    flat = pt.predict(videos[:, 0], batch_size=3)
    np.testing.assert_allclose(flat.sum(-1), 1.0, rtol=1e-5)


def test_builders_take_the_presets_recipes():
    """The configs carry the JAX presets' widths and recipes; the
    builders hand them to the trainers (built on the CPU at depth 1)."""
    pre, cls, mir = (PRESETS["ego_timemamba_pretrain"],
                     PRESETS["ego_ek100_cls"], PRESETS["ego_ek100_mir"])
    vision = EGO_TIMEMAMBA_PRETRAIN["model"]["vision_cfg"]
    assert vision["num_frames"] == pre["model"]["num_frames"] == 4
    for key in ("embed_dim", "depth", "num_heads", "ln_pre",
                "attention_style", "is_tanh_gating"):
        assert vision[key] == pre["model"][key], key
    assert EGO_TIMEMAMBA_PRETRAIN["model"]["embed_dim"] == \
        pre["model"]["project_embed_dim"]
    assert EGO_TIMEMAMBA_PRETRAIN["opt"]["lr"] == pre["opt"]["learning_rate"]
    assert EGO_TIMEMAMBA_PRETRAIN["batch_size"] == \
        pre["loader"]["batch_size"]
    assert EGO_EK100_CLS["num_classes"] == cls["dataset"]["num_classes"]
    assert EGO_EK100_CLS["opt"]["lr"] == cls["opt"]["learning_rate"]
    assert EGO_EK100_CLS["aug"] == dict(
        smoothing=cls["aug"]["smoothing"], mixup_alpha=cls["aug"]["mixup"],
        cutmix_alpha=cls["aug"]["cutmix"])
    for key in ("embed_dim", "depth", "num_frames", "patch_size",
                "img_size"):
        assert EGO_EK100_CLS["model"][key] == cls["model"][key], key
    assert CLIP_TIMEMAMBA_B_EK100_MIR["opt"]["lr"] == \
        mir["opt"]["learning_rate"]
    small = dict(EGO_TIMEMAMBA_PRETRAIN, model=dict(
        EGO_TIMEMAMBA_PRETRAIN["model"], vision_cfg=dict(vision, depth=1,
                                                         img_size=32),
        text_cfg=dict(TEXT, layers=1)))
    pretrainer = build_clip_pretrainer(small, device="cpu")
    group = pretrainer.optimizer.param_groups[0]
    assert group["betas"] == (0.9, 0.98) and group["weight_decay"] == 0.01
    assert pretrainer.schedule(100) == pytest.approx(3e-5)
    mir_trainer = build_clip_mir(dict(CLIP_TIMEMAMBA_B_EK100_MIR,
                                      model=small["model"]), device="cpu",
                                 warmup_steps=10, total_steps=50)
    assert mir_trainer.schedule(0) == 0.0
    assert mir_trainer.schedule(10) == pytest.approx(1e-5)
    assert mir_trainer.optimizer.param_groups[0]["betas"] == (0.9, 0.98)
    classifier = build_ek100_cls(dict(EGO_EK100_CLS, model=dict(
        EGO_EK100_CLS["model"], depth=1, img_size=32)), device="cpu")
    assert classifier.model.fc_cls.weight.shape == (3806, 192)
    assert classifier.model.vision_tower.head is None
    assert (classifier.mixup_alpha, classifier.cutmix_alpha,
            classifier.smoothing) == (0.8, 1.0, 0.1)
