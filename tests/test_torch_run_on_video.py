"""The port's VTG run-on-video pipeline against the JAX package's, on the
CPU, at tests/test_run_on_video.py's widths: the CLIP image and text
towers and the UniVTG-Mamba model drawn by numpy into the JAX trees and
carried over (``clip_image_tower_from_jax``, ``text_transformer_from_jax``,
``vtg_from_jax``). On ``.npy`` videos that the decode shrinks and
enlarges: the frame features within 1e-4, the per-token query features
within 1e-5, and ``ground_video``'s windows (their order, spans within
1e-4 of the duration) and saliency within 1e-4.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_mamba_suite_tpu.data.tokenizer import WordTokenizer as JaxWords
from video_mamba_suite_tpu.models.clip import ClipImageTower, TextTransformer
from video_mamba_suite_tpu.tasks.vtg import run_on_video as jax_rov
from video_mamba_suite_tpu.tasks.vtg.model import UniVTGMamba as JaxVtg
from video_mamba_suite_torch.data.tokenizer import WordTokenizer
from video_mamba_suite_torch.models import (
    clip_image_tower_from_jax,
    text_transformer_from_jax,
    vtg_from_jax,
)
from video_mamba_suite_torch.tasks.vtg import (
    UniVTGMamba,
    VtgFeatureExtractor,
    ground_video,
)

IMG_CFG = dict(img_size=32, patch_size=16, width=24, layers=1, heads=4,
               output_dim=16)
TXT_CFG = dict(context_length=8, vocab_size=64, width=16, heads=4, layers=1,
               output_dim=16)
CORPUS = ["a person opens the door", "the dog runs to the door"]
QUERY = "a person opens the door"
# the frame features: the antialiased resize, one fp32 ViT block and the
# L2 norm; each within 1e-4 (unit vectors)
VIDEO_TOL = 1e-4
# the query's per-token features: one fp32 text block and the norm
TEXT_TOL = 1e-5
# spans (fractions of the duration) and saliency after two DBM layers
GROUND_TOL = 1e-4


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
    """The JAX references compile without most of XLA's optimization
    passes: they are small, and the compile is most of their time."""
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


def _init(module, seed, *args):
    """A parameter tree for ``module`` in the shapes ``jax.eval_shape``
    gives (no compiled init), drawn by numpy: A_log the log of 1..16, a
    small dt, norms near 1, other vectors and matrices at unit fan-in
    scale."""
    shapes = jax.eval_shape(module.init, {"params": jax.random.PRNGKey(0)},
                            *args)
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "A_log":
            x = np.log(rng.uniform(1.0, 16.0, shape))
        elif name == "dt_bias":
            x = np.log(np.expm1(rng.uniform(0.01, 0.1, shape)))
        elif name == "scale" or (name.endswith("_w") and len(shape) == 1):
            x = rng.uniform(0.5, 1.5, shape)
        elif len(shape) <= 1:
            x = 0.5 * rng.standard_normal(shape)
        elif len(shape) == 3:              # conv kernels (k, in, out)
            x = rng.standard_normal(shape) / np.sqrt(shape[0] * shape[1])
        else:
            x = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def pipelines():
    """Both packages' extractors and VTG models on the same weights."""
    ip = _init(ClipImageTower(**IMG_CFG), 0, jnp.zeros((1, 32, 32, 3)))
    tp = _init(TextTransformer(**TXT_CFG), 1, jnp.zeros((1, 8), jnp.int32))
    jax_ex = jax_rov.VtgFeatureExtractor(
        ip, tp, IMG_CFG, TXT_CFG,
        tokenizer=JaxWords(corpus=CORPUS, context_length=8), clip_len=2.0)
    ex = VtgFeatureExtractor(
        clip_image_tower_from_jax(ip), text_transformer_from_jax(tp),
        IMG_CFG, TXT_CFG,
        tokenizer=WordTokenizer(corpus=CORPUS, context_length=8),
        clip_len=2.0, device="cpu")
    jm = JaxVtg(txt_dim=16, vid_dim=18, embed_dim=32, depth=2, impl="assoc")
    params = _init(jm, 3, jnp.zeros((1, 8, 16)), jnp.ones((1, 8)),
                   jnp.zeros((1, 75, 18)), jnp.ones((1, 75)))
    model = UniVTGMamba(txt_dim=16, vid_dim=18, embed_dim=32, depth=2,
                        device="cpu")
    model.load_state_dict(vtg_from_jax(params))
    return dict(jax_ex=jax_ex, ex=ex, jm=jm, params=params, model=model)


# (frames, H, W): 5 clips shrunk to 32², 3 clips enlarged
VIDEOS = [(300, 40, 48), (180, 20, 26)]


def _video(tmp_path, shape):
    frames = np.random.default_rng(0).integers(0, 255, shape + (3,)
                                               ).astype(np.uint8)
    path = tmp_path / "clip.npy"
    np.save(path, frames)
    return str(path)


@pytest.mark.parametrize("shape", VIDEOS, ids=["shrink", "enlarge"])
def test_video_features_match_jax(pipelines, tmp_path, shape):
    path = _video(tmp_path, shape)
    got = pipelines["ex"].video_features(path)
    want = pipelines["jax_ex"].video_features(path)
    assert got.shape == want.shape == (-(-shape[0] // 60), 16)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=VIDEO_TOL)


def test_text_features_match_jax(pipelines):
    queries = [QUERY, "the dog runs", "unknown words only here"]
    got = pipelines["ex"].text_features(queries)
    want = pipelines["jax_ex"].text_features(queries)
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=TEXT_TOL)


@pytest.mark.parametrize("shape", VIDEOS, ids=["shrink", "enlarge"])
def test_ground_video_matches_jax(pipelines, tmp_path, shape):
    path = _video(tmp_path, shape)
    p = pipelines
    got = ground_video(p["ex"], p["model"], path, QUERY, top_k=4, max_q_l=8)
    want = jax_rov.ground_video(p["jax_ex"], p["jm"], p["params"], path,
                                QUERY, top_k=4, max_q_l=8)
    clips = -(-shape[0] // 60)
    duration = clips * 2.0
    assert got["query"] == want["query"] == QUERY
    g, w = (np.asarray(r["pred_relevant_windows"]) for r in (got, want))
    assert g.shape == w.shape == (min(4, clips), 3)
    # the same clips in the same order: equal probabilities would tie
    np.testing.assert_allclose(g[:, 2], w[:, 2], rtol=0, atol=GROUND_TOL)
    assert np.all(np.diff(g[:, 2]) <= 0)
    np.testing.assert_allclose(g[:, :2] / duration, w[:, :2] / duration,
                               rtol=0, atol=GROUND_TOL)
    assert all(math.isfinite(v) for v in g.ravel())
    assert len(got["pred_saliency_scores"]) == clips
    np.testing.assert_allclose(got["pred_saliency_scores"],
                               want["pred_saliency_scores"], rtol=0,
                               atol=GROUND_TOL)
