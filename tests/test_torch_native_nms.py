"""The port's native 1-D NMS (``csrc/nms_1d.cc`` built with the host's C++
compiler, ``tasks/tal/nms.py`` ``nms_1d`` / ``soft_nms_1d``) against the
JAX package's native op (``ops/native.py`` ``nms_1d_native`` /
``soft_nms_1d_native``) and the port's plain versions, exactly: the same
kept indices in the same order and the same float32 scores.
"""

import numpy as np
import pytest
import torch

from video_mamba_suite_torch.ops import _build
from video_mamba_suite_torch.tasks.tal import nms as port_nms


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as in every port test file: the workers beside
    this file are not oversubscribed."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True, scope="module")
def _jax_without_most_optimizations():
    """The JAX op here is host C++ and compiles nothing in XLA; should a
    JAX function compile, it does so without most of XLA's optimization
    passes, as in every port test file."""
    import jax

    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


def _jax_native():
    from video_mamba_suite_tpu.ops import native

    assert native._nms_lib() is not None
    return native


def _threshold_pairs(threshold, steps=40):
    """Pairs of 10-long segments [0, 10], [t, t + 10] whose IoU
    (10 - t) / (10 + t) steps across ``threshold`` in relative steps of
    3e-9 of t (``tests/test_torch_tal.py``'s cases): every IoU within
    1e-6 of the threshold, some within float32's rounding of it."""
    t0 = 10 * (1 - threshold) / (1 + threshold)
    for k in range(-steps, steps + 1):
        t = t0 * (1 + 3e-9 * k)
        yield np.array([[0.0, 10.0], [t, t + 10.0]])


def _detections(seed, n=300):
    rng = np.random.default_rng(seed)
    start = rng.uniform(0, 100, n)
    segs = np.stack([start, start + rng.uniform(1, 20, n)], 1)
    return segs, rng.uniform(0, 1, n)


def _same(got, want):
    """Equal arrays: dtype, shape and every value."""
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("threshold", [0.1, 0.3, 0.5, 0.7])
@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
def test_native_nms_at_the_iou_threshold(threshold, soft):
    native = _jax_native()
    scores = np.array([0.9, 0.8])
    for segs in _threshold_pairs(threshold):
        if soft:
            got = port_nms.soft_nms_1d(segs, scores, threshold, 0.5, 0.001)
            _same(got, native.soft_nms_1d_native(segs, scores, threshold,
                                                 0.5, 0.001))
            _same(got, port_nms.soft_nms_1d_ref(segs, scores, threshold,
                                                0.5, 0.001))
        else:
            got = port_nms.nms_1d(segs, scores, threshold)
            _same([got], [native.nms_1d_native(segs, scores, threshold)])
            _same([got], [port_nms.nms_1d_ref(segs, scores, threshold)])


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("method", [0, 1, 2], ids=["hard", "linear",
                                                   "gaussian"])
def test_native_nms_on_detections_matches_jax_native(seed, method):
    """Exactly the JAX native op; the plain versions keep the same
    segments in the same order, their scores within one float32 ulp
    (a float64 exp rounded once against expf)."""
    native = _jax_native()
    segs, scores = _detections(seed)
    keep = port_nms.nms_1d(segs, scores, 0.5)
    _same([keep], [native.nms_1d_native(segs, scores, 0.5)])
    _same([keep], [port_nms.nms_1d_ref(segs, scores, 0.5)])
    got = port_nms.soft_nms_1d(segs, scores, 0.1, 0.5, 0.001, method)
    _same(got, native.soft_nms_1d_native(segs, scores, 0.1, 0.5, 0.001,
                                         method))
    plain = port_nms.soft_nms_1d_ref(segs, scores, 0.1, 0.5, 0.001, method)
    _same([got[0], got[2]], [plain[0], plain[2]])
    np.testing.assert_array_max_ulp(got[1].astype(np.float32),
                                    plain[1].astype(np.float32), maxulp=1)


@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
def test_batched_nms_native_equals_plain(soft, monkeypatch):
    segs, scores = _detections(5)
    cls = np.random.default_rng(5).integers(0, 4, len(scores))
    kw = dict(iou_threshold=0.1 if soft else 0.5, min_score=0.001,
              max_seg_num=60, use_soft_nms=soft, multiclass=True, sigma=0.5,
              voting_thresh=0.7)
    got = port_nms.batched_nms(segs, scores, cls, **kw)
    monkeypatch.setattr(port_nms, "nms_1d", port_nms.nms_1d_ref)
    monkeypatch.setattr(port_nms, "soft_nms_1d", port_nms.soft_nms_1d_ref)
    want = port_nms.batched_nms(segs, scores, cls, **kw)
    assert len(got[0]) == 60
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got[1], want[1], rtol=2e-7, atol=0)


def test_native_nms_on_no_segments():
    empty = np.zeros((0, 2))
    assert port_nms.nms_1d(empty, np.zeros(0), 0.5).shape == (0,)
    segs, scores, inds = port_nms.soft_nms_1d(empty, np.zeros(0))
    assert segs.shape == (0, 2) and scores.shape == inds.shape == (0,)


def test_the_op_is_built_once_into_the_build_directory():
    port_nms.nms_1d(np.array([[0.0, 1.0]]), np.array([1.0]), 0.5)
    target = _build._host_target("nms_1d")
    assert target.exists() and target.parent == _build.BUILD_DIR
    assert target.name.startswith("nms_1d-host-")
    assert _build.build_host("nms_1d") == target


def test_a_failed_build_raises_and_nothing_falls_back(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises((RuntimeError, OSError)):
        port_nms.nms_1d(np.array([[0.0, 1.0]]), np.array([1.0]), 0.5)
    segs, scores = _detections(7, n=20)
    with pytest.raises((RuntimeError, OSError)):
        port_nms.batched_nms(segs, scores, np.zeros(20, int), 0.1, 0.001,
                             10)
    assert not list((tmp_path / "build").glob("*.so"))
