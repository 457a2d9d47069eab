"""ActivityNet-style detection mAP at temporal IoU thresholds (the port's
own copy of the JAX package's ``tasks/tal/metrics.py``): per-class
interpolated AP, each prediction matched greedily to the unmatched ground
truth of its video with the best tIoU."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


def segment_iou(target: np.ndarray, candidates: np.ndarray) -> np.ndarray:
    """tIoU of one (2,) segment against (N, 2) candidates."""
    t1 = np.maximum(target[0], candidates[:, 0])
    t2 = np.minimum(target[1], candidates[:, 1])
    inter = np.clip(t2 - t1, 0, None)
    union = ((candidates[:, 1] - candidates[:, 0])
             + (target[1] - target[0]) - inter)
    return inter / np.maximum(union, 1e-8)


def interpolated_prec_rec(prec: np.ndarray, rec: np.ndarray) -> float:
    """AP as the area under the precision envelope."""
    mprec = np.hstack([[0], prec, [0]])
    mrec = np.hstack([[0], rec, [1]])
    for i in range(len(mprec) - 1)[::-1]:
        mprec[i] = max(mprec[i], mprec[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0] + 1
    return float(np.sum((mrec[idx] - mrec[idx - 1]) * mprec[idx]))


def compute_average_precision_detection(
        gt: Dict[str, np.ndarray], preds: List[tuple],
        tiou_thresholds: np.ndarray) -> np.ndarray:
    """AP of one class at each tIoU: ``gt`` maps a video to its (N, 2)
    segments, ``preds`` are (video, start, end, score)."""
    npos = sum(len(v) for v in gt.values())
    ap = np.zeros(len(tiou_thresholds))
    if npos == 0 or len(preds) == 0:
        return ap
    preds = sorted(preds, key=lambda p: -p[3])
    lock = {vid: np.zeros((len(tiou_thresholds), len(segs)), bool)
            for vid, segs in gt.items()}
    tp = np.zeros((len(tiou_thresholds), len(preds)))
    fp = np.zeros((len(tiou_thresholds), len(preds)))
    for pi, (vid, s, e, _) in enumerate(preds):
        segs = gt.get(vid)
        if segs is None or len(segs) == 0:
            fp[:, pi] = 1
            continue
        ious = segment_iou(np.array([s, e]), segs)
        order = np.argsort(-ious)
        for ti, thr in enumerate(tiou_thresholds):
            matched = False
            for gi in order:
                if ious[gi] < thr:
                    break
                if lock[vid][ti, gi]:
                    continue
                lock[vid][ti, gi] = True
                tp[ti, pi] = 1
                matched = True
                break
            if not matched:
                fp[ti, pi] = 1
    tp_cum = np.cumsum(tp, axis=1)
    fp_cum = np.cumsum(fp, axis=1)
    rec = tp_cum / npos
    prec = tp_cum / np.maximum(tp_cum + fp_cum, 1e-8)
    for ti in range(len(tiou_thresholds)):
        ap[ti] = interpolated_prec_rec(prec[ti], rec[ti])
    return ap


class ANETdetection:
    """The evaluator: ground truth {video: [(start, end, label), ...]},
    tIoU thresholds 0.3 to 0.7 by 0.1 unless given."""

    def __init__(self, ground_truth: Dict[str, List[tuple]],
                 tiou_thresholds: Optional[Sequence[float]] = None):
        self.tiou_thresholds = np.asarray(
            tiou_thresholds if tiou_thresholds is not None
            else np.linspace(0.3, 0.7, 5))
        self.labels = sorted({lab for v in ground_truth.values()
                              for *_, lab in v})
        self.gt_by_class: Dict[int, Dict[str, np.ndarray]] = {}
        for ci, lab in enumerate(self.labels):
            per_vid = {}
            for vid, anns in ground_truth.items():
                segs = [(s, e) for (s, e, lb) in anns if lb == lab]
                if segs:
                    per_vid[vid] = np.asarray(segs, np.float64)
            self.gt_by_class[ci] = per_vid
        self.label_to_idx = {lab: i for i, lab in enumerate(self.labels)}

    def evaluate(self, preds: Dict[str, np.ndarray], verbose: bool = False):
        """``preds``: "video-id" (list), "t-start", "t-end", "score" and
        "label" (arrays). Returns (mAP at each tIoU, their mean)."""
        ap = np.zeros((len(self.tiou_thresholds), len(self.labels)))
        vids = preds["video-id"]
        starts = np.asarray(preds["t-start"], np.float64)
        ends = np.asarray(preds["t-end"], np.float64)
        scores = np.asarray(preds["score"], np.float64)
        labels = np.asarray(preds["label"])
        for ci, lab in enumerate(self.labels):
            cls_preds = [(vids[i], starts[i], ends[i], scores[i])
                         for i in range(len(vids)) if labels[i] == lab]
            ap[:, ci] = compute_average_precision_detection(
                self.gt_by_class[ci], cls_preds, self.tiou_thresholds)
        mAP = ap.mean(axis=1)
        avg = float(mAP.mean())
        if verbose:
            for t, m in zip(self.tiou_thresholds, mAP):
                print(f"|tIoU = {t:.2f}: mAP = {m * 100:.2f} (%)")
            print(f"Average mAP: {avg * 100:.2f} (%)")
        return mAP, avg
