"""The port's CLIP dual encoder and EK100 MIR serving against the JAX
package's, on the CPU at small widths: the same numpy clips and token ids,
the JAX weights carried over by ``clip_from_jax`` (per-layer and stacked
video-tower trees), the towers, the retrieval metrics, the MIR engine's
``encode_dataset`` / ``evaluate``, and EgoSchema zero-shot QA."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_mamba_suite_torch.models import (
    CLIP,
    ClipImageTower,
    TextTransformer,
    clip_from_jax,
    clip_image_tower_from_jax,
    text_transformer_from_jax,
)
from video_mamba_suite_torch.ops import LAUNCHES
from video_mamba_suite_torch.tasks.egocentric import (
    MirFinetuner,
    egoschema_zero_shot,
)
from video_mamba_suite_torch.tasks.egocentric import metrics
from video_mamba_suite_tpu.models import clip as jclip
from video_mamba_suite_tpu.models.convert import stack_block_params
from video_mamba_suite_tpu.tasks.egocentric import egoschema as jegoschema
from video_mamba_suite_tpu.tasks.egocentric import metrics as jmetrics
from video_mamba_suite_tpu.tasks.egocentric.finetune import \
    MirFinetuner as JaxMirFinetuner


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
VISION = dict(img_size=32, patch_size=16, embed_dim=32, depth=2,
              num_heads=2, num_frames=2, ln_pre=True,
              attention_style="timesformer-div", is_tanh_gating=True)
VIVIM = dict(img_size=32, patch_size=16, embed_dim=32, depth=2,
             num_frames=2, if_devide_out=True)
EMBED = 16
# every embedding within 1e-5 of its largest magnitude: fp32 on both
# sides, sums in another order
REL_TOL = 1e-5


def _close(got, want, rel=REL_TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= rel, err


def _inputs(seed, n=4):
    rng = np.random.default_rng(seed)
    videos = rng.standard_normal((n, 2, 32, 32, 3)).astype(np.float32)
    texts = rng.integers(0, TEXT["vocab_size"], (n, TEXT["context_length"]))
    texts[0, 2] = texts[0, 5] = TEXT["vocab_size"] - 1    # a tied eot: the
    return videos, texts.astype(np.int32)                 # first one pools


def _jax_clip(tower="timemamba", **vision):
    cfg = dict(VISION if tower == "timemamba" else VIVIM, **vision)
    return jclip.CLIP(embed_dim=EMBED, vision_tower=tower,
                      vision_cfg=dict(cfg, impl="assoc"), text_cfg=TEXT)


def _port_clip(params, tower="timemamba", **vision):
    cfg = dict(VISION if tower == "timemamba" else VIVIM, **vision)
    model = CLIP(embed_dim=EMBED, vision_tower=tower, vision_cfg=cfg,
                 text_cfg=TEXT, device="cpu")
    model.load_state_dict(clip_from_jax(params), strict=True)
    return model.eval()


@pytest.fixture(scope="module")
def timemamba_clip():
    """A JAX CLIP-TimeMamba (per-layer tree, tanh gates moved off 0, which
    would hide the temporal branch), its parameters, the inputs, and the
    JAX MIR engine's embeddings of them (batches of 2)."""
    videos, texts = _inputs(0)
    jm = _jax_clip()
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(videos[:1]),
                              jnp.asarray(texts[:1]))
    params = jax.tree_util.tree_map(np.asarray, params)
    for i in range(VISION["depth"]):
        params["params"]["visual"][f"block{i}"]["alpha_timeattn"] = \
            np.float32(0.7)
    engine = JaxMirFinetuner(jm)
    engine.params = params
    want = engine.encode_dataset(videos, texts, batch_size=2)
    return params, videos, texts, engine, want


@pytest.mark.parametrize("tree,attn_flash", [
    ("per-layer", None), ("per-layer", "row"), ("stacked", None)])
def test_clip_timemamba_matches_jax(timemamba_clip, tree, attn_flash):
    """CLIP-TimeMamba from the per-layer tree, with the spatial attention
    on the einsum path and on K10 ("row": the JAX K10 in interpret mode,
    the plain version here), and from the stacked tree the JAX CLI builds
    (scan_blocks=True)."""
    params, videos, texts, _, (want_img, want_txt) = timemamba_clip
    vision = {} if attn_flash is None else dict(attn_flash=attn_flash)
    if tree == "stacked":
        params = jax.tree_util.tree_map(lambda x: x, params)
        params["params"]["visual"] = stack_block_params(
            params["params"]["visual"], VISION["depth"])
        vision["scan_blocks"] = True
    if vision:
        jm = _jax_clip(**vision)
        want_img, want_txt, _ = jax.jit(jm.apply)(
            params, jnp.asarray(videos), jnp.asarray(texts))
    vision.pop("scan_blocks", None)
    model = _port_clip(params, **vision)
    before = dict(LAUNCHES)
    with torch.no_grad():
        img, txt, scale = model(torch.from_numpy(videos),
                                torch.from_numpy(texts))
    assert dict(LAUNCHES) == before            # the plain versions on CPU
    _close(img, want_img)
    _close(txt, want_txt)
    assert scale.item() == pytest.approx(1 / 0.07, rel=1e-6)


def _init_apply(jm, key, *inputs):
    """Parameters and outputs of a JAX module, in one compiled call."""
    def run(key, *inputs):
        params = jm.init(key, *inputs)
        return params, jm.apply(params, *inputs)
    params, out = jax.jit(run)(key, *inputs)
    return jax.tree_util.tree_map(np.asarray, params), out


def test_clip_vivim_matches_jax():
    videos, texts = _inputs(1, n=2)
    params, want = _init_apply(_jax_clip("vivim"), jax.random.PRNGKey(1),
                               jnp.asarray(videos), jnp.asarray(texts))
    with torch.no_grad():
        got = _port_clip(params, "vivim")(torch.from_numpy(videos),
                                          torch.from_numpy(texts))
    for g, w in zip(got, want):
        _close(g, w)


def test_text_transformer_matches_jax():
    """Pooled at the eot token (the first of two tied in one caption) and,
    with return_tokens, every token's ln_final state."""
    _, texts = _inputs(2)
    jm = jclip.TextTransformer(**TEXT, output_dim=EMBED)

    def run(key, text):
        params = jm.init(key, text)
        return params, jm.apply(params, text), jm.apply(
            params, text, return_tokens=True)
    params, want, want_tokens = jax.jit(run)(jax.random.PRNGKey(2),
                                             jnp.asarray(texts))
    model = TextTransformer(**TEXT, output_dim=EMBED,
                            generator=torch.Generator())
    model.load_state_dict(text_transformer_from_jax(params), strict=True)
    with torch.no_grad():
        _close(model(torch.from_numpy(texts)), want)
        _close(model(torch.from_numpy(texts), return_tokens=True),
               want_tokens)


def test_clip_image_tower_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    kw = dict(img_size=32, patch_size=16, width=32, layers=2, heads=4,
              output_dim=EMBED)
    params, want = _init_apply(jclip.ClipImageTower(**kw),
                               jax.random.PRNGKey(3), jnp.asarray(x))
    model = ClipImageTower(**kw, generator=torch.Generator())
    model.load_state_dict(clip_image_tower_from_jax(params), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    _close(got, want)


def test_encode_dataset_and_evaluate_match_jax(timemamba_clip):
    """MirFinetuner.encode_dataset (batches of 2) against the JAX engine's,
    and evaluate's six metrics against the JAX engine's on the same
    relevancy matrix and caption index."""
    params, videos, texts, engine, (want_img, want_txt) = timemamba_clip
    port = MirFinetuner(_port_clip(params))
    img, txt = port.encode_dataset(videos, texts, batch_size=2)
    assert img.dtype == np.float32 and img.shape == (4, EMBED)
    _close(img, want_img)
    _close(txt, want_txt)
    rel = metrics.create_relevancy_matrix(np.array([0, 1, 0, 2]),
                                          np.array([1, 0, 0, 2]))
    index = np.array([3, 1, 0, 2])
    got = port.evaluate(videos, texts, rel, batch_size=2, text_index=index)
    want = engine.evaluate(videos, texts, rel, batch_size=2,
                           text_index=index)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == pytest.approx(want[key], abs=1e-6), key


def test_metrics_match_jax_exactly():
    rng = np.random.default_rng(4)
    sim = rng.standard_normal((7, 9))
    classes = rng.integers(0, 3, 7), rng.integers(0, 3, 9)
    rel = metrics.create_relevancy_matrix(*classes)
    assert np.array_equal(rel, jmetrics.create_relevancy_matrix(*classes))
    for name in ("get_mAP", "get_nDCG"):
        assert getattr(metrics, name)(sim, rel) == \
            getattr(jmetrics, name)(sim, rel)
    assert metrics.calculate_mAP(sim, rel) == jmetrics.calculate_mAP(sim, rel)
    assert np.array_equal(metrics.calculate_nDCG(sim, rel, reduction="none"),
                          jmetrics.calculate_nDCG(sim, rel,
                                                  reduction="none"))
    assert np.array_equal(metrics.calculate_k_counts(rel),
                          jmetrics.calculate_k_counts(rel))
    groups = rng.integers(0, 4, 11)
    got = metrics.get_marginal_indexes(groups, 5)
    want = jmetrics.get_marginal_indexes(groups, 5)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    probs = rng.random((6, 11))
    assert np.array_equal(metrics.marginalize(probs, got),
                          jmetrics.marginalize(probs, want))
    cm = rng.integers(0, 5, (4, 4))
    assert metrics.get_mean_accuracy(cm) == jmetrics.get_mean_accuracy(cm)


def test_egoschema_matches_jax():
    rng = np.random.default_rng(5)
    proj_v = rng.standard_normal((2 * 8 * 8 * 3, 6))
    proj_t = rng.standard_normal((4, 6))

    def encode_video(v):
        return v.reshape(v.shape[0], -1) @ proj_v

    def encode_text(ids):
        return ids @ proj_t

    def tokenizer(options):
        return np.array([[len(o), o.count("a"), ord(o[0]) % 7, 1]
                         for o in options], np.float64)

    questions = [dict(video=rng.standard_normal((2, 8, 8, 3)),
                      options=["a cat", "the dog", "banana", "apple pie",
                               "zebra"],
                      answer=int(rng.integers(0, 5))) for _ in range(6)]
    got = egoschema_zero_shot(encode_video, encode_text, questions, tokenizer)
    want = jegoschema.egoschema_zero_shot(encode_video, encode_text,
                                          questions, tokenizer)
    assert got == want
