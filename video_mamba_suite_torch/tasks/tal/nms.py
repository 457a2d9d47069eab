"""1-D segment NMS on the host: hard and soft (linear or gaussian),
class-aware, with segment voting (the port's own copy of the JAX package's
``tasks/tal/nms.py``). It runs once a video at eval time on at most a few
thousand segments.

``nms_1d`` and ``soft_nms_1d`` run the native op ``csrc/nms_1d.cc`` (the
JAX package's own C++ op, the default path of its ``nms_1d`` /
``soft_nms_1d``), built with the host's C++ compiler on first use and
loaded with ctypes; a failed build raises, nothing falls back.
``nms_1d_ref`` and ``soft_nms_1d_ref`` are their plain versions in numpy,
which compute as the op does: scores and IoUs in float32, the IoU 0 where
the union is not positive, a stable sort by float32 score, float32
decays. So where an IoU lies within float32's rounding of the threshold
they keep the segments that the op keeps; a gaussian decay's float64 exp
rounded once can differ from the op's expf by one float32 ulp.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from ...ops._build import load_host


def _native() -> ctypes.CDLL:
    """The native op, built and loaded on first use."""
    lib = load_host("nms_1d")
    lib.nms_1d.restype = ctypes.c_int64
    lib.soft_nms_1d.restype = ctypes.c_int64
    return lib


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def nms_1d(segs: np.ndarray, scores: np.ndarray,
           iou_threshold: float) -> np.ndarray:
    """Hard NMS by the native op: the kept indices by descending score
    (float32 scores, ties in input order)."""
    segs = np.ascontiguousarray(segs, np.float32).reshape(-1, 2)
    scores = np.ascontiguousarray(scores, np.float32)
    keep = np.empty(len(scores), np.int64)
    kept = _native().nms_1d(_f32p(segs), _f32p(scores),
                            ctypes.c_int64(len(scores)),
                            ctypes.c_float(iou_threshold), _i64p(keep))
    return keep[:kept]


def soft_nms_1d(segs: np.ndarray, scores: np.ndarray,
                iou_threshold: float = 0.1, sigma: float = 0.5,
                min_score: float = 0.001, method: int = 2
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Soft NMS by the native op (``soft_nms_1d_ref`` says what it
    computes). Returns (the segments as given, their decayed scores as
    float64, indices) in the order taken."""
    segs32 = np.array(segs, np.float32).reshape(-1, 2)
    scores32 = np.array(scores, np.float32)
    inds = np.empty(len(scores32), np.int64)
    kept = _native().soft_nms_1d(
        _f32p(segs32), _f32p(scores32), ctypes.c_int64(len(scores32)),
        ctypes.c_float(iou_threshold), ctypes.c_float(sigma),
        ctypes.c_float(min_score), ctypes.c_int64(method), _i64p(inds))
    inds = inds[:kept]
    return (np.asarray(segs, np.float64)[inds].reshape(-1, 2),
            scores32[inds].astype(np.float64), inds)


def _iou_1d(seg: np.ndarray, segs: np.ndarray) -> np.ndarray:
    """float32 IoU of ``seg`` (2,) with each row of ``segs`` (n, 2), as the
    C++ op: 0 where the union is not positive."""
    inter = np.maximum(np.float32(0), np.minimum(seg[1], segs[:, 1])
                       - np.maximum(seg[0], segs[:, 0]))
    union = (seg[1] - seg[0]) + (segs[:, 1] - segs[:, 0]) - inter
    positive = union > 0
    return np.where(positive, inter / np.where(positive, union,
                                               np.float32(1)),
                    np.float32(0))


def nms_1d_ref(segs: np.ndarray, scores: np.ndarray,
               iou_threshold: float) -> np.ndarray:
    """Hard NMS, plain version: the kept indices by descending score (float32 scores,
    ties in input order)."""
    segs = np.asarray(segs, np.float32)
    scores = np.asarray(scores, np.float32)
    thr = np.float32(iou_threshold)
    order = np.argsort(-scores, kind="stable")
    keep = []
    alive = np.ones(len(segs), bool)
    for i in order:
        if not alive[i]:
            continue
        keep.append(i)
        alive[i] = False
        rest = order[alive[order]]
        if rest.size:
            ious = _iou_1d(segs[i], segs[rest])
            alive[rest[ious > thr]] = False
    return np.array(keep, np.int64)


def soft_nms_1d_ref(segs: np.ndarray, scores: np.ndarray,
                    iou_threshold: float = 0.1, sigma: float = 0.5,
                    min_score: float = 0.001, method: int = 2
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Soft NMS, plain version: take the highest score (the first of equal ones), decay
    the scores of the segments still alive by their overlap with it
    (method 1 linear, 2 gaussian, else hard), repeat while a score reaches
    ``min_score``. Scores decay in float32. Returns (the segments as
    given, their decayed scores as float64, indices) in the order
    taken."""
    segs32 = np.asarray(segs, np.float32)
    scores32 = np.array(scores, np.float32)
    thr, sig = np.float32(iou_threshold), np.float32(sigma)
    floor = np.float32(min_score)
    inds = []
    alive = np.ones(len(segs32), bool)
    for _ in range(len(segs32)):
        live = np.where(alive)[0]
        if live.size == 0:
            break
        i = live[np.argmax(scores32[live])]
        if scores32[i] < floor:
            break
        inds.append(i)
        alive[i] = False
        rest = np.where(alive)[0]
        if rest.size == 0:
            break
        ious = _iou_1d(segs32[i], segs32[rest])
        if method == 1:
            w = np.where(ious > thr, np.float32(1) - ious, np.float32(1))
        elif method == 2:
            # expf of the float32 argument: float64 exp rounded once
            w = np.exp((-(ious * ious) / sig).astype(np.float64)).astype(
                np.float32)
        else:
            w = np.where(ious > thr, np.float32(0), np.float32(1))
        scores32[rest] *= w
        alive[rest[scores32[rest] < floor]] = False
    inds = np.array(inds, np.int64)
    return (np.asarray(segs, np.float64)[inds].reshape(-1, 2),
            scores32[inds].astype(np.float64), inds)


def seg_voting(nms_segs: np.ndarray, all_segs: np.ndarray,
               all_scores: np.ndarray, iou_threshold: float,
               score_offset: float = 1.5) -> np.ndarray:
    """Each kept segment replaced by the mean of the candidates that
    overlap it by at least ``iou_threshold``, weighted by score +
    ``score_offset``."""
    if len(nms_segs) == 0:
        return nms_segs
    offset_scores = all_scores + score_offset
    left = np.maximum(nms_segs[:, None, 0], all_segs[None, :, 0])
    right = np.minimum(nms_segs[:, None, 1], all_segs[None, :, 1])
    inter = np.clip(right - left, 0, None)
    nms_lens = nms_segs[:, 1] - nms_segs[:, 0]
    all_lens = all_segs[:, 1] - all_segs[:, 0]
    iou = inter / np.maximum(nms_lens[:, None] + all_lens[None, :] - inter,
                             1e-8)
    weights = (iou >= iou_threshold).astype(np.float64) * offset_scores[None]
    weights /= np.maximum(weights.sum(axis=1, keepdims=True), 1e-8)
    return weights @ all_segs


def batched_nms(segs: np.ndarray, scores: np.ndarray, cls_idxs: np.ndarray,
                iou_threshold: float, min_score: float, max_seg_num: int,
                use_soft_nms: bool = True, multiclass: bool = True,
                sigma: float = 0.5, voting_thresh: float = 0.75
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """NMS per class (or over all with ``multiclass`` off), at most
    ``max_seg_num`` kept per class and in all, then voting when
    ``voting_thresh`` > 0; the result by descending score."""
    segs = np.asarray(segs, np.float64)
    scores = np.asarray(scores, np.float64)
    cls_idxs = np.asarray(cls_idxs)
    if segs.shape[0] == 0:
        return np.zeros((0, 2)), np.zeros((0,)), np.zeros((0,),
                                                           cls_idxs.dtype)

    def one_class(s, sc, ci):
        if use_soft_nms:
            new_segs, new_scores, inds = soft_nms_1d(
                s, sc, iou_threshold, sigma, min_score, method=2)
            new_cls = ci[inds]
        else:
            valid = sc > min_score
            s2, sc2, ci2 = s[valid], sc[valid], ci[valid]
            inds = nms_1d(s2, sc2, iou_threshold)
            new_segs, new_scores, new_cls = s2[inds], sc2[inds], ci2[inds]
        if max_seg_num > 0:
            new_segs = new_segs[:max_seg_num]
            new_scores = new_scores[:max_seg_num]
            new_cls = new_cls[:max_seg_num]
        if voting_thresh > 0 and len(new_segs):
            new_segs = seg_voting(new_segs, s, sc, voting_thresh)
        return new_segs, new_scores, new_cls

    if multiclass:
        parts = [one_class(segs[cls_idxs == c], scores[cls_idxs == c],
                           cls_idxs[cls_idxs == c])
                 for c in np.unique(cls_idxs)]
        new_segs = np.concatenate([p[0] for p in parts], axis=0)
        new_scores = np.concatenate([p[1] for p in parts], axis=0)
        new_cls = np.concatenate([p[2] for p in parts], axis=0)
    else:
        new_segs, new_scores, new_cls = one_class(segs, scores, cls_idxs)
    order = np.argsort(-new_scores, kind="stable")
    if max_seg_num > 0:
        order = order[:max_seg_num]
    return new_segs[order], new_scores[order], new_cls[order]
