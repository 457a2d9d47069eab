"""The port's RandAugment and random erasing against the JAX package's, on
the CPU: every op of ``_OPS`` at two magnitudes through its level
function, ``RandAugmentVideo``, ``RandomErasingVideo`` in its three modes,
``train_augment_clip`` and ``make_train_augment`` on the K400 preset's
``aug`` section. Both run numpy on the host, so each clip and each draw
from the same seed is equal exactly.
"""

import jax
import numpy as np
import pytest
import torch

from video_mamba_suite_tpu.configs.presets import PRESETS
from video_mamba_suite_tpu.data import video_augment as jax_aug
from video_mamba_suite_torch.data import video_augment as aug


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Nothing here runs torch ops; one intra-op thread keeps the test
    workers beside this file from being oversubscribed all the same."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True, scope="module")
def _jax_without_most_optimizations():
    """Nothing here compiles JAX; should it, it compiles without most of
    XLA's optimization passes, as in every port test file."""
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


def _clip(seed, shape=(3, 20, 24, 3)):
    return np.random.default_rng(seed).integers(0, 256, shape,
                                                dtype=np.uint8)


def test_ops_tables_match():
    assert list(aug._OPS) == list(jax_aug._OPS)
    assert aug._MAX_LEVEL == jax_aug._MAX_LEVEL
    assert aug._FILL == jax_aug._FILL


@pytest.mark.parametrize("name", list(jax_aug._OPS))
@pytest.mark.parametrize("level", [3.0, 9.5])
def test_each_op_matches_jax(name, level):
    clip = _clip(1)
    fn, level_fn = aug._OPS[name]
    jfn, jlevel_fn = jax_aug._OPS[name]
    assert (level_fn is None) == (jlevel_fn is None)
    for seed in (0, 1):          # both signs where the level draws one
        args = level_fn(level, np.random.default_rng(seed)) if level_fn \
            else ()
        jargs = jlevel_fn(level, np.random.default_rng(seed)) if jlevel_fn \
            else ()
        assert args == jargs
        got, want = fn(clip, *args), jfn(clip, *jargs)
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


def test_edge_cases_of_pixel_ops():
    flat = np.full((2, 6, 6, 3), 77, np.uint8)
    for name in ("AutoContrast", "Equalize"):
        np.testing.assert_array_equal(aug._OPS[name][0](flat),
                                      jax_aug._OPS[name][0](flat))
    for bits in (0, 8):
        np.testing.assert_array_equal(aug.posterize(_clip(2), bits),
                                      jax_aug.posterize(_clip(2), bits))


@pytest.mark.parametrize("config", ["rand-m7-n4-mstd0.5-inc1",
                                    "rand-m9-n2", "rand-m3-n6-mstd1.0"])
def test_rand_augment_matches_jax(config):
    got, want = aug.RandAugmentVideo(config), jax_aug.RandAugmentVideo(config)
    assert (got.magnitude, got.num_layers, got.mstd) == \
        (want.magnitude, want.num_layers, want.mstd)
    rg, rw = np.random.default_rng(3), np.random.default_rng(3)
    for i in range(6):
        clip = _clip(10 + i)
        np.testing.assert_array_equal(got(clip, rg), want(clip, rw))
    assert rg.random() == rw.random()        # the same draws were taken


@pytest.mark.parametrize("mode,count", [("pixel", 1), ("rand", 2),
                                        ("const", 3)])
def test_random_erasing_matches_jax(mode, count):
    kw = dict(probability=0.6, mode=mode, max_count=count)
    got, want = aug.RandomErasingVideo(**kw), jax_aug.RandomErasingVideo(**kw)
    clip = np.random.default_rng(4).standard_normal(
        (8, 20, 24, 3)).astype(np.float32)
    rg, rw = np.random.default_rng(5), np.random.default_rng(5)
    out = got(clip, rg)
    np.testing.assert_array_equal(out, want(clip, rw))
    assert not np.array_equal(out, clip)     # some frame was erased
    assert rg.random() == rw.random()


def test_make_train_augment_on_the_preset_matches_jax():
    cfg = PRESETS["recognition_k400_vivim_tiny"]["aug"]
    assert cfg["aa"] == "rand-m7-n4-mstd0.5-inc1" and cfg["reprob"] == 0.25
    got, want = aug.make_train_augment(cfg), jax_aug.make_train_augment(cfg)
    rg, rw = np.random.default_rng(0), np.random.default_rng(0)
    for i in range(4):
        clip = _clip(20 + i, (4, 32, 32, 3))
        g, w = got(clip, rg), want(clip, rw)
        assert g.dtype == w.dtype == np.float32 and g.shape == clip.shape
        np.testing.assert_array_equal(g, w)
    assert aug.make_train_augment({}) is None
    assert jax_aug.make_train_augment({}) is None
    # a normalised clip without either op
    clip = _clip(30)
    np.testing.assert_array_equal(
        aug.train_augment_clip(clip, rng=np.random.default_rng(1)),
        jax_aug.train_augment_clip(clip, rng=np.random.default_rng(1)))
