"""The port's temporal action localization slice against the JAX package's,
on the CPU: ``MambaDBM`` (both routes, masked), the masked 1-D blocks,
``MaskMambaBlock``, ``ActionMambaDetector``, label assignment, losses,
decode, NMS, mAP, data, one ``TalTrainer`` step and the converters.

JAX runs its modules with ``impl="ref"`` (the plain scan; off the TPU its
DBM always runs one scan per direction); the port runs its plain versions
on the CPU: at 40 steps the fused bidirectional route with the shared
parameters passed twice, above 64 steps one scan per direction. Weights
and inputs are drawn by numpy from a seed in the ranges the inits give;
they fill the JAX tree and reach the port through the ``*_from_jax``
converters. Small widths keep the file quick.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_mamba_suite_tpu.data.sampler import (
    sharded_epoch_order as jax_epoch_order,
)
from video_mamba_suite_tpu.models import common as jax_common
from video_mamba_suite_tpu.models.convert import convert_dbm_mixer
from video_mamba_suite_tpu.models.mamba import MambaDBM as JaxMambaDBM
from video_mamba_suite_tpu.tasks.tal import data as jax_data
from video_mamba_suite_tpu.tasks.tal import losses as jax_losses
from video_mamba_suite_tpu.tasks.tal import metrics as jax_metrics
from video_mamba_suite_tpu.tasks.tal import model as jax_model
from video_mamba_suite_tpu.tasks.tal import nms as jax_nms
from video_mamba_suite_tpu.tasks.tal import train as jax_train
from video_mamba_suite_torch.data import sharded_epoch_order
from video_mamba_suite_torch.models import (
    MambaDBM,
    MaskedConv1D,
    MaskMambaBlock,
    dbm_mixer_from_jax,
    dbm_mixer_from_state_dict,
    mask_mamba_block_from_jax,
    max_pool_1d,
    tal_detector_from_jax,
)
from video_mamba_suite_torch.models import mamba as port_mamba
from video_mamba_suite_torch.tasks.tal import (
    ActionMambaDetector,
    ANETdetection,
    TalDataset,
    TalTrainer,
    batched_nms,
    collate_tal,
    ctr_diou_loss_1d,
    ctr_giou_loss_1d,
    decode_single_video,
    fuse_external_scores,
    label_points,
    make_synthetic_tal,
    sigmoid_focal_loss,
    tal_losses,
    truncate_feats,
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


# fp32: each output within 2e-5 of its largest magnitude (and 2e-5
# relative); the two frameworks sum in other orders
REL_TOL = 2e-5
# one train step, fp32: the losses and the new normaliser within 2e-5
# relative; each parameter after the update within 2e-6 where its gradient
# exceeds 1e-4 of that parameter's largest, and within twice the rate
# elsewhere (Adam divides by the gradient's square root, so where the
# gradient is as small as the two frameworks' rounding of it the update's
# size is rounding noise), as the anticipation trainer's test holds it
PARAM_ATOL = 2e-6
SMALL_GRAD = 1e-4
LR = 1e-3
# NMS in float64 on both sides, the same operations in the same order
NMS_TOL = dict(rtol=1e-12, atol=1e-12)
REGRESSION = ((0, 4), (4, 16), (16, 10000))
DETECTOR = dict(input_dim=12, num_classes=3, max_seq_len=128, embd_dim=16,
                backbone_arch=(1, 1, 2), regression_range=REGRESSION)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, rel=REL_TOL, msg=""):
    w = _np(want)
    np.testing.assert_allclose(_np(got), w, atol=rel * np.abs(w).max(),
                               rtol=rel, err_msg=msg)


def _draw(shapes, seed):
    """Parameters for a JAX tree of ``shapes``, as fp32 numpy arrays in
    the ranges the inits give (A_log = log of 1..16, small dt, norms near
    1, a drop-path scale of order 1 so the mixers count)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "A_log":
            x = np.log(rng.uniform(1.0, 16.0, shape))
        elif name == "dt_bias":            # softplus of it in (0.01, 0.1)
            x = np.log(np.expm1(rng.uniform(0.01, 0.1, shape)))
        elif name in ("norm_w", "scale"):
            x = rng.uniform(0.5, 1.5, shape)
        elif len(shape) <= 1:
            x = 0.5 * rng.standard_normal(shape)
        elif len(shape) == 3:              # conv kernels (k, in, out)
            x = rng.standard_normal(shape) / np.sqrt(shape[0] * shape[1])
        else:                              # flax kernels are (in, out)
            x = rng.standard_normal(shape) / np.sqrt(shape[0])
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _init(module, seed, *args, **kwargs):
    """A parameter tree for ``module`` from ``jax.eval_shape`` (flax's init
    compiles for seconds on the CPU), drawn by ``_draw``."""
    shapes = jax.eval_shape(
        functools.partial(module.init, **kwargs),
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)},
        *args)
    return _draw(shapes, seed)


def _mask(batch, length, valid):
    """(batch, length) float masks, row i valid for its first valid[i]."""
    m = np.zeros((batch, length), np.float32)
    for i, v in enumerate(valid):
        m[i, :v] = 1.0
    return m


@pytest.mark.parametrize("length", [40, 100], ids=["fused-l40", "two-l100"])
def test_dbm_mixer_matches_jax(monkeypatch, length):
    """Forward and every parameter's gradient with a ragged mask, the port
    at 40 steps through its fused route (the shared parameters passed to
    both directions) and at 100 through one scan per direction, against
    the JAX module's two calls; then the valid steps against an unpadded
    run of the shorter row."""
    rng = np.random.default_rng(length)
    x = rng.standard_normal((2, length, 16)).astype(np.float32)
    mask = _mask(2, length, (length, length - 7))
    cot = rng.standard_normal((2, length, 16)).astype(np.float32)
    jm = JaxMambaDBM(d_model=16, d_state=8, expand=1, impl="ref")
    params = _init(jm, length, jnp.asarray(x), jnp.asarray(mask))

    def loss(p):
        out = jm.apply(p, jnp.asarray(x), jnp.asarray(mask))
        return jnp.sum(out * cot), out

    (_, want), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    port = MambaDBM(16, d_state=8, expand=1, device="cpu")
    port.load_state_dict(dbm_mixer_from_jax(params))
    fused = []
    inner = port_mamba.mamba_inner_bidir
    monkeypatch.setattr(port_mamba, "mamba_inner_bidir",
                        lambda *a, **k: fused.append(1) or inner(*a, **k))
    got = port(_t(x), _t(mask))
    (got * _t(cot)).sum().backward()
    assert bool(fused) == (length <= 64)
    _close(got, want)
    want_grads = dbm_mixer_from_jax(grads)
    for name, p in port.named_parameters():
        _close(p.grad, want_grads[name], msg=name)
    with torch.no_grad():
        short = port(_t(x[1:, :length - 7]))
    _close(got[1:, :length - 7], short)


@pytest.mark.parametrize("kernel,stride", [(1, 1), (3, 1), (1, 2), (3, 2)])
def test_masked_conv1d_matches_jax(kernel, stride):
    rng = np.random.default_rng(kernel + 10 * stride)
    x = rng.standard_normal((2, 15, 6)).astype(np.float32)
    mask = _mask(2, 15, (15, 9))
    jm = jax_common.MaskedConv1D(5, kernel, stride)
    params = _init(jm, 1, jnp.asarray(x), jnp.asarray(mask))
    want, want_mask = jm.apply(params, jnp.asarray(x), jnp.asarray(mask))
    port = MaskedConv1D(6, 5, kernel, stride, generator=torch.Generator())
    conv = params["params"]["Conv_0"]
    with torch.no_grad():
        port.weight.copy_(_t(np.asarray(conv["kernel"]).transpose(2, 1, 0)))
        port.bias.copy_(_t(conv["bias"]))
    got, got_mask = port(_t(x), _t(mask))
    _close(got, want)
    np.testing.assert_array_equal(_np(got_mask), _np(want_mask))


@pytest.mark.parametrize("length", [7, 10, 13])
def test_max_pool_1d_matches_jax(length):
    rng = np.random.default_rng(length)
    x = rng.standard_normal((2, length, 4)).astype(np.float32)
    mask = _mask(2, length, (length, length - 3))
    want, want_mask = jax_common.max_pool_1d(jnp.asarray(x),
                                             jnp.asarray(mask))
    got, got_mask = max_pool_1d(_t(x), _t(mask))
    assert got.shape == want.shape
    np.testing.assert_array_equal(_np(got), _np(want))
    np.testing.assert_array_equal(_np(got_mask), _np(want_mask))


@pytest.mark.parametrize("mixer", ["dbm", "vim"])
def test_mask_mamba_block_matches_jax(mixer):
    """Norm, mixer (a scan per direction at 90 steps), mask, the affine
    drop-path's scale (eval mode) and the pool to 45 steps."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 90, 16)).astype(np.float32)
    mask = _mask(2, 90, (90, 61))
    blk = jax_common.MaskMambaBlock(16, mixer=mixer, n_ds_stride=2,
                                    impl="ref")
    tree = _init(blk, 4, jnp.asarray(x), jnp.asarray(mask))
    want, want_mask = jax.jit(blk.apply)(tree, jnp.asarray(x),
                                         jnp.asarray(mask))
    port = MaskMambaBlock(16, mixer=mixer, n_ds_stride=2, device="cpu")
    port.load_state_dict(mask_mamba_block_from_jax(tree))
    with torch.no_grad():
        got, got_mask = port.eval()(_t(x), _t(mask))
    assert got.shape == (2, 45, 16)
    _close(got, want)
    np.testing.assert_array_equal(_np(got_mask), _np(want_mask))


def test_fpn1d_matches_jax():
    """The top-down neck on a 3-level pyramid with ragged masks."""
    rng = np.random.default_rng(6)
    lengths = (24, 12, 6)
    feats = [rng.standard_normal((2, n, 8)).astype(np.float32)
             for n in lengths]
    masks = [_mask(2, n, (n, n // 2 + 1)) for n in lengths]
    neck = jax_model.FPN1D(out_channel=8)
    args = ([jnp.asarray(f) for f in feats], [jnp.asarray(m) for m in masks])
    tree = _init(neck, 5, *args)
    want, _ = jax.jit(neck.apply)(tree, *args)
    port = ActionMambaDetector(**dict(DETECTOR, embd_dim=8,
                                      backbone_arch=(1, 1, 2),
                                      regression_range=REGRESSION[1:]),
                               fpn_type="fpn", device="cpu")
    sd = tal_detector_from_jax({"neck": tree["params"]})
    port.neck.load_state_dict({k[len("neck."):]: v for k, v in sd.items()})
    with torch.no_grad():
        got, _ = port.neck([_t(f) for f in feats], [_t(m) for m in masks])
    for level, (g, w) in enumerate(zip(got, want)):
        _close(g, w, msg=f"level {level}")


def _detector_pair(seed=0, drop_path_rate=0.1):
    jm = jax_model.ActionMambaDetector(**DETECTOR, impl="ref",
                                       drop_path_rate=drop_path_rate)
    T = DETECTOR["max_seq_len"]
    params = _init(jm, seed, jnp.zeros((1, T, DETECTOR["input_dim"])),
                   jnp.ones((1, T)))
    port = ActionMambaDetector(**DETECTOR, drop_path_rate=drop_path_rate,
                               device="cpu")
    port.load_state_dict(tal_detector_from_jax(params))
    return jm, params, port


def test_detector_matches_jax():
    """Logits, offsets and masks of every level at 128 steps, fp32: mixers
    at 128 steps (a scan per direction) and at 64 (fused)."""
    jm, params, port = _detector_pair()
    T = DETECTOR["max_seq_len"]
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, T, 12)).astype(np.float32)
    mask = _mask(2, T, (T, 100))
    fwd = jax.jit(lambda p, x, m: jm.apply(p, x, m, deterministic=True))
    want = fwd(params, jnp.asarray(x), jnp.asarray(mask))
    with torch.no_grad():
        got = port.eval()(_t(x), _t(mask))
    assert [m.shape[1] for m in got[2]] == [128, 64, 32]
    for kind, g_levels, w_levels in zip(("logits", "offsets", "masks"),
                                        got, want):
        for level, (g, w) in enumerate(zip(g_levels, w_levels)):
            _close(g, w, msg=f"{kind} level {level}")


def _gt(seed, batch=2, n=5, length=192):
    rng = np.random.default_rng(seed)
    start = rng.uniform(0, length - 40, (batch, n))
    segs = np.stack([start, start + rng.uniform(2, 60, (batch, n))], -1)
    # a tie of two lengths in the first row, a duplicate segment
    segs[0, 1] = segs[0, 0] + [0.0, 0.0005]
    labels = rng.integers(0, 3, (batch, n)).astype(np.int32)
    valid = np.ones((batch, n), bool)
    valid[1, 3:] = False
    return segs.astype(np.float32), labels, valid


LEVELS = (192, 96, 48)


def _points():
    gen = jax_model.PointGenerator(192 * 8, 3, 2, REGRESSION)
    return np.concatenate(gen(LEVELS), axis=0)


def test_label_points_matches_jax_exactly():
    points = _points()
    segs, labels, valid = _gt(11)
    want_cls, want_reg = jax.jit(jax_model.label_points, static_argnums=4)(
        jnp.asarray(points), jnp.asarray(segs), jnp.asarray(labels),
        jnp.asarray(valid), 3)
    got_cls, got_reg = label_points(_t(points), _t(segs), _t(labels),
                                    _t(valid), 3)
    assert _np(got_cls).sum() > 10
    np.testing.assert_array_equal(_np(got_cls), _np(want_cls))
    np.testing.assert_array_equal(_np(got_reg), _np(want_reg))


def test_tal_losses_match_jax():
    rng = np.random.default_rng(12)
    points = _points()
    segs, labels, valid = _gt(12)
    gt_cls, gt_off = (np.array(a) for a in label_points(
        _t(points), _t(segs), _t(labels), _t(valid), 3))
    masks = [_mask(2, n, (n, n // 2)) for n in LEVELS]
    logits = [rng.standard_normal((2, n, 3)).astype(np.float32) * 3
              for n in LEVELS]
    offsets = [np.abs(rng.standard_normal((2, n, 2))).astype(np.float32) * 4
               for n in LEVELS]
    losses = jax.jit(functools.partial(jax_model.tal_losses, num_classes=3,
                                       label_smoothing=0.1))
    want, want_norm = losses(
        [jnp.asarray(m) for m in masks], [jnp.asarray(v) for v in logits],
        [jnp.asarray(v) for v in offsets], jnp.asarray(gt_cls),
        jnp.asarray(gt_off), jnp.asarray(100.0))
    got, got_norm = tal_losses(
        [_t(m) for m in masks], [_t(v) for v in logits],
        [_t(v) for v in offsets], _t(gt_cls), _t(gt_off),
        torch.tensor(100.0), 3, label_smoothing=0.1)
    _close(got_norm, want_norm)
    for k in want:
        _close(got[k], want[k], msg=k)
    a = np.abs(rng.standard_normal((50, 2))).astype(np.float32)
    b = np.abs(rng.standard_normal((50, 2))).astype(np.float32)
    _close(ctr_giou_loss_1d(_t(a), _t(b), "mean"),
           jax_losses.ctr_giou_loss_1d(jnp.asarray(a), jnp.asarray(b),
                                       "mean"))
    _close(ctr_diou_loss_1d(_t(a), _t(b), "sum"),
           jax_losses.ctr_diou_loss_1d(jnp.asarray(a), jnp.asarray(b), "sum"))
    _close(sigmoid_focal_loss(_t(a - 1), _t(b > 0.5), alpha=-1, gamma=0.5),
           jax_losses.sigmoid_focal_loss(jnp.asarray(a - 1),
                                         jnp.asarray(b > 0.5), alpha=-1,
                                         gamma=0.5))


def _rows(segs, scores, cls):
    """Detections as rows (class, score, start, end), sorted: ties in the
    top-k and the NMS order differ between the frameworks."""
    rows = np.concatenate([np.asarray(cls, np.float64)[:, None],
                           np.asarray(scores, np.float64)[:, None],
                           np.asarray(segs, np.float64)], axis=1)
    return rows[np.lexsort(rows.T[::-1])]


def test_decode_single_video_matches_jax():
    rng = np.random.default_rng(13)
    points = jax_model.PointGenerator(192 * 8, 3, 2, REGRESSION)(LEVELS)
    masks = [_mask(1, n, (n // 2 + 3,))[0] for n in LEVELS]
    logits = [rng.standard_normal((n, 3)).astype(np.float32) * 3
              for n in LEVELS]
    offsets = [np.abs(rng.standard_normal((n, 2))).astype(np.float32) * 3
               for n in LEVELS]
    want = jax_model.decode_single_video(
        [jnp.asarray(p) for p in points], [jnp.asarray(m) for m in masks],
        [jnp.asarray(v) for v in logits], [jnp.asarray(v) for v in offsets],
        pre_nms_topk=100)
    got = decode_single_video([_t(p) for p in points],
                              [_t(m) for m in masks],
                              [_t(v) for v in logits],
                              [_t(v) for v in offsets], pre_nms_topk=100)
    assert len(got[0]) == len(want[0]) > 100
    np.testing.assert_allclose(_rows(*got), _rows(*want), rtol=1e-6,
                               atol=1e-5)


def _detections(seed, n=300):
    rng = np.random.default_rng(seed)
    start = rng.uniform(0, 100, n)
    segs = np.stack([start, start + rng.uniform(1, 20, n)], 1)
    return segs, rng.uniform(0, 1, n), rng.integers(0, 4, n)


@pytest.mark.parametrize("soft", [True, False], ids=["soft", "hard"])
def test_batched_nms_matches_jax(soft):
    """Against the JAX package's default NMS path, its float32 C++ op
    (``csrc/nms_1d.cc`` through ``ops/native.py``), which the port's
    float32 arithmetic copies."""
    from video_mamba_suite_tpu.ops import native

    assert native._nms_lib() is not None
    segs, scores, cls = _detections(14 + soft)
    kw = dict(iou_threshold=0.1 if soft else 0.5, min_score=0.001,
              max_seg_num=60, use_soft_nms=soft, multiclass=True,
              sigma=0.5, voting_thresh=0.7)
    want = jax_nms.batched_nms(segs, scores, cls, **kw)
    got = batched_nms(segs, scores, cls, **kw)
    assert len(got[0]) == len(want[0]) == 60
    np.testing.assert_allclose(_rows(*got), _rows(*want), **NMS_TOL)
    got = batched_nms(segs, scores, cls, **dict(kw, multiclass=False))
    want = jax_nms.batched_nms(segs, scores, cls,
                               **dict(kw, multiclass=False))
    np.testing.assert_allclose(_rows(*got), _rows(*want), **NMS_TOL)


def _threshold_pairs(threshold, steps=40):
    """Pairs of 10-long segments [0, 10], [t, t + 10] whose IoU
    (10 - t) / (10 + t) steps across ``threshold`` in relative steps of
    3e-9 of t: every IoU lies within 1e-6 of the threshold, and some
    within float32's rounding of it."""
    t0 = 10 * (1 - threshold) / (1 + threshold)
    for k in range(-steps, steps + 1):
        t = t0 * (1 + 3e-9 * k)
        yield np.array([[0.0, 10.0], [t, t + 10.0]])


@pytest.mark.parametrize("soft", [True, False], ids=["soft", "hard"])
def test_nms_at_the_iou_threshold_matches_jax_default(monkeypatch, soft):
    """Where an IoU sits within 1e-6 of the threshold, the port keeps what
    the JAX default path (its float32 C++ op) keeps, with the same
    scores, also on ``_detections`` with some segments moved onto the
    threshold. The JAX float64 fallback decides some of these pairs the
    other way, so a float64 port would not match the default."""
    from video_mamba_suite_tpu.ops import native

    scores, cls = np.array([0.9, 0.8]), np.array([0, 0])
    kw = dict(min_score=0.001, max_seg_num=60, use_soft_nms=soft,
              multiclass=True, sigma=0.5, voting_thresh=0.0)
    splits = 0
    for threshold in (0.1, 0.3, 0.5, 0.7):
        kw["iou_threshold"] = threshold
        for segs in _threshold_pairs(threshold):
            want = jax_nms.batched_nms(segs, scores, cls, **kw)
            got = batched_nms(segs, scores, cls, **kw)
            np.testing.assert_array_equal(got[2], want[2])
            np.testing.assert_allclose(_rows(*got), _rows(*want),
                                       **NMS_TOL)
            with monkeypatch.context() as m:
                m.setattr(native, "nms_1d_native", lambda *a: None)
                m.setattr(native, "soft_nms_1d_native", lambda *a: None)
                fallback = jax_nms.batched_nms(segs, scores, cls, **kw)
            splits += len(fallback[0]) != len(want[0])
    assert soft or splits > 0
    segs, det_scores, det_cls = _detections(14 + soft)
    # move every tenth segment onto the threshold of its predecessor
    t = 0.5 if not soft else 0.1
    for i in range(1, len(segs), 10):
        start, length = segs[i - 1, 0], segs[i - 1, 1] - segs[i - 1, 0]
        shift = length * (1 - t) / (1 + t)
        segs[i] = [start + shift, start + shift + length]
        det_cls[i] = det_cls[i - 1]
    kw.update(iou_threshold=t, voting_thresh=0.7)
    want = jax_nms.batched_nms(segs, det_scores, det_cls, **kw)
    got = batched_nms(segs, det_scores, det_cls, **kw)
    np.testing.assert_allclose(_rows(*got), _rows(*want), **NMS_TOL)


def test_anet_map_and_score_fusion_match_jax():
    rng = np.random.default_rng(15)
    gt = {f"v{i}": [(s, s + rng.uniform(1, 10), int(rng.integers(3)))
                    for s in rng.uniform(0, 50, 4)] for i in range(5)}
    segs, scores, cls = _detections(16, 120)
    preds = {"video-id": [f"v{i % 5}" for i in range(120)],
             "t-start": segs[:, 0] / 2, "t-end": segs[:, 1] / 2,
             "score": scores, "label": cls % 3}
    want = jax_metrics.ANETdetection(gt).evaluate(preds)
    got = ANETdetection(gt).evaluate(preds)
    assert want[1] > 0
    np.testing.assert_allclose(got[0], want[0], rtol=1e-12)
    assert got[1] == pytest.approx(want[1], rel=1e-12)
    ext = rng.uniform(0, 1, 6)
    for g, w in zip(fuse_external_scores(segs[:20], scores[:20], ext),
                    jax_train.fuse_external_scores(segs[:20], scores[:20],
                                                   ext)):
        np.testing.assert_array_equal(g, w)


def test_data_matches_jax():
    """Synthetic videos, truncation, collation (training and eval) and
    the epoch order: the same values from the same seeds."""
    want_items = jax_data.make_synthetic_tal(5, 3, 6, 100, seed=2)
    items = make_synthetic_tal(5, 3, 6, 100, seed=2)
    for g, w in zip(items, want_items):
        for k in ("feats", "segments", "labels"):
            np.testing.assert_array_equal(g[k], w[k])
    it = items[0]
    for crop in (None, (0.5, 0.8)):
        got = truncate_feats(it["feats"], it["segments"], it["labels"], 60,
                             0.5, np.random.default_rng(3), crop)
        want = jax_data.truncate_feats(it["feats"], it["segments"],
                                       it["labels"], 60, 0.5,
                                       np.random.default_rng(3), crop)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    for training in (True, False):
        got = collate_tal(items[:3], 100 if training else 70, 4, training)
        want = jax_data.collate_tal(items[:3], 100 if training else 70, 4,
                                    training)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert sharded_epoch_order(11, 3) == [int(i)
                                          for i in jax_epoch_order(11, 3)]


def test_tal_dataset_matches_jax(tmp_path):
    """A json annotation file and .npy features read by ``TalDataset``:
    seconds to the feature grid, the split, and the truncation of a
    training item from the same seed."""
    rng = np.random.default_rng(5)
    db = {}
    for i, (subset, length) in enumerate((("validation", 90),
                                          ("test", 40),
                                          ("validation", 50))):
        np.save(tmp_path / f"v{i}.npy",
                rng.standard_normal((6, length)).astype(np.float32))
        db[f"v{i}"] = {"subset": subset, "duration": length / 7.5,
                       "fps": 30.0, "annotations": [
                           {"segment": [1.0 + i, 3.5 + i], "label_id": i},
                           {"segment": [4.0, 5.25], "label_id": 0}]}
    (tmp_path / "db.json").write_text(json.dumps({"database": db}))
    for training in (True, False):
        kw = dict(json_file=str(tmp_path / "db.json"),
                  feat_folder=str(tmp_path), split=["validation"],
                  max_seq_len=64, is_training=training, seed=1)
        port, ref = TalDataset(**kw), jax_data.TalDataset(**kw)
        assert len(port) == len(ref) == 2
        for i in range(2):
            got, want = port[i], ref[i]
            assert got.keys() == want.keys()
            for k in got:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


class _DrawnInit:
    """A JAX detector whose ``init`` returns given weights: the JAX
    trainer's ``init`` then builds its step around them without running
    flax's init (eagerly, 20 s on the CPU)."""

    def __init__(self, module, params):
        self.module, self.params = module, params

    def __getattr__(self, name):
        return getattr(self.module, name)

    def init(self, *args, **kwargs):
        return jax.tree_util.tree_map(jnp.asarray, self.params)


def test_trainer_step_matches_jax():
    """One ``TalTrainer.train_step`` (drop-path off, no warmup, fp32; one
    level of 64 steps, so its one mixer takes the port's fused route;
    the pyramid is the detector test's) against the JAX trainer's jitted
    step from the same weights: the loss dict, the new normaliser, and the
    parameters after the clipped AdamW update with weight decay. Then
    ``evaluate`` runs on the port's EMA weights and ``train_epoch`` takes
    its one full batch."""
    T = 64
    items = make_synthetic_tal(4, 3, 12, T, seed=4)
    batch = collate_tal(items[:2], T, 32)
    kw = dict(input_dim=12, num_classes=3, max_seq_len=T, embd_dim=16,
              regression_range=((0, 10000),), backbone_arch=(1, 1, 0),
              lr=LR, warmup_steps=0, total_steps=20, grad_clip=1.0)
    jtr = jax_train.TalTrainer(**kw, impl="ref")
    module = jtr.model.clone(drop_path_rate=0.0)
    params = _init(module, 21, jnp.asarray(batch[0]), jnp.asarray(batch[1]),
                   deterministic=True)
    jtr.model = _DrawnInit(module, params)
    want = jtr.train_step(*batch)
    port = TalTrainer(**kw, drop_path_rate=0.0, device="cpu")
    port.model.load_state_dict(tal_detector_from_jax(params))
    got = port.train_step(*batch)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=REL_TOL), k
    _close(port.loss_norm, jtr.loss_norm)
    before = tal_detector_from_jax(params)
    after = tal_detector_from_jax(jax.device_get(jtr.params))
    for name, p in port.model.named_parameters():
        assert np.abs(_np(after[name]) - _np(before[name])).max() > 0, name
        grad = np.abs(_np(p.grad))
        big = grad > SMALL_GRAD * grad.max()
        diff = np.abs(_np(p) - _np(after[name]))
        assert diff[big].max(initial=0) <= PARAM_ATOL, name
        assert diff.max() <= 2 * LR, name
    mAP, avg = port.evaluate(items[2:])
    assert mAP.shape == (5,) and np.isfinite(avg)
    stats = port.train_epoch(items, batch_size=3)     # one batch of three
    assert set(stats) == set(want) and np.isfinite(list(stats.values())).all()


def test_two_level_trainer_step_matches_jax():
    """One ``TalTrainer.train_step`` through two pyramid levels above 64
    steps (``backbone_arch=(1, 1, 1)`` at 256 steps: the stem at 256 and
    one branch level at 128), so every mixer takes the chunked route (K3
    and K4 on the card, their plain versions here), against the JAX
    trainer's jitted step from the same weights: the loss dict, the new
    normaliser and the parameters after the clipped AdamW update."""
    T = 256
    items = make_synthetic_tal(2, 3, 8, T, seed=6)
    batch = collate_tal(items, T, 32)
    kw = dict(input_dim=8, num_classes=3, max_seq_len=T, embd_dim=16,
              regression_range=((0, 8), (8, 10000)), backbone_arch=(1, 1, 1),
              lr=LR, warmup_steps=0, total_steps=20, grad_clip=1.0)
    jtr = jax_train.TalTrainer(**kw, impl="ref")
    module = jtr.model.clone(drop_path_rate=0.0)
    params = _init(module, 22, jnp.asarray(batch[0]), jnp.asarray(batch[1]),
                   deterministic=True)
    jtr.model = _DrawnInit(module, params)
    want = jtr.train_step(*batch)
    port = TalTrainer(**kw, drop_path_rate=0.0, device="cpu")
    assert port.model.level_lengths(T) == [256, 128]
    port.model.load_state_dict(tal_detector_from_jax(params))
    got = port.train_step(*batch)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=REL_TOL), k
    _close(port.loss_norm, jtr.loss_norm)
    before = tal_detector_from_jax(params)
    after = tal_detector_from_jax(jax.device_get(jtr.params))
    for name, p in port.model.named_parameters():
        assert np.abs(_np(after[name]) - _np(before[name])).max() > 0, name
        grad = np.abs(_np(p.grad))
        big = grad > SMALL_GRAD * grad.max()
        diff = np.abs(_np(p) - _np(after[name]))
        assert diff[big].max(initial=0) <= PARAM_ATOL, name
        assert diff.max() <= 2 * LR, name


def test_dbm_converters_agree():
    """An upstream DBM mixer's state_dict reaches the same port weights
    directly (``dbm_mixer_from_state_dict``) and through the JAX tree
    (``convert_dbm_mixer`` then ``dbm_mixer_from_jax``)."""
    rng = np.random.default_rng(17)
    d_model, d_inner, n, rank, width = 16, 16, 8, 1, 4
    sd = {"in_proj.weight": (4 * d_inner, d_model),
          "conv1d.weight": (d_inner, 1, width), "conv1d.bias": (d_inner,),
          "x_proj.weight": (rank + 2 * n, d_inner),
          "dt_proj.weight": (d_inner, rank), "dt_proj.bias": (d_inner,),
          "A_log": (d_inner, n), "D": (d_inner,),
          "out_proj.weight": (d_model, 2 * d_inner)}
    sd = {"mixer." + k: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)) for k, s in sd.items()}
    got = dbm_mixer_from_state_dict(sd, "mixer.")
    want = dbm_mixer_from_jax(convert_dbm_mixer(sd, "mixer."))
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_array_equal(_np(got[k]), _np(want[k]))
    MambaDBM(d_model, d_state=n, expand=1, device="cpu").load_state_dict(got)
