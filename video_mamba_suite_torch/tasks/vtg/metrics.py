"""Moment-retrieval mAP / R1 and highlight-detection HIT@1 / mAP (the
port's own copy of the JAX package's ``tasks/vtg/metrics.py``, host
numpy; upstream eval/eval.py:20-290). Submissions: [{qid,
pred_relevant_windows: [[s, e, score], ...], pred_saliency_scores:
[...]}]; ground truth: [{qid, relevant_windows: [[s, e], ...]}].
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..tal.metrics import compute_average_precision_detection


def _iou_paired(p: np.ndarray, g: np.ndarray) -> np.ndarray:
    inter = np.clip(np.minimum(p[:, 1], g[:, 1]) - np.maximum(p[:, 0], g[:, 0]), 0, None)
    union = (p[:, 1] - p[:, 0]) + (g[:, 1] - g[:, 0]) - inter
    return inter / np.maximum(union, 1e-8)


def _iou_cross(p: np.ndarray, g: np.ndarray) -> np.ndarray:
    inter = np.clip(
        np.minimum(p[:, None, 1], g[None, :, 1])
        - np.maximum(p[:, None, 0], g[None, :, 0]), 0, None,
    )
    union = (
        (p[:, None, 1] - p[:, None, 0]) + (g[None, :, 1] - g[None, :, 0]) - inter
    )
    return inter / np.maximum(union, 1e-8)


def compute_mr_ap(submission: List[dict], ground_truth: List[dict],
                  iou_thds=None, max_pred_windows: int = 10) -> Dict[str, float]:
    """Per-query AP averaged over queries (eval.py:20-70)."""
    iou_thds = np.asarray(iou_thds if iou_thds is not None
                          else np.round(np.linspace(0.5, 0.95, 10), 2))
    gt_by_qid = {d["qid"]: np.asarray(d["relevant_windows"], np.float64)
                 for d in ground_truth}
    ap_list = []
    for d in submission:
        qid = d["qid"]
        preds = [(str(qid), w[0], w[1], w[2])
                 for w in d["pred_relevant_windows"][:max_pred_windows]]
        gt = {str(qid): gt_by_qid.get(qid, np.zeros((0, 2)))}
        ap_list.append(
            compute_average_precision_detection(gt, preds, iou_thds)
        )
    ap = np.mean(np.stack(ap_list), axis=0) if ap_list else np.zeros(len(iou_thds))
    out = {str(t): float(100 * a) for t, a in zip(iou_thds, ap)}
    out["average"] = float(100 * ap.mean())
    return out


def compute_mr_r1(submission: List[dict], ground_truth: List[dict],
                  iou_thds=None):
    """R1@tIoU of the top-ranked span vs its best-matching GT (eval.py:73-100)."""
    iou_thds = np.asarray(iou_thds if iou_thds is not None
                          else np.round(np.linspace(0.3, 0.95, 14), 2))
    gt_by_qid = {d["qid"]: np.asarray(d["relevant_windows"], np.float64)
                 for d in ground_truth}
    preds, gts = [], []
    for d in submission:
        top = np.asarray(d["pred_relevant_windows"][0][:2], np.float64)
        g = gt_by_qid[d["qid"]]
        ious = _iou_cross(top[None], g)[0]
        gts.append(g[int(np.argmax(ious))])
        preds.append(top)
    preds, gts = np.asarray(preds), np.asarray(gts)
    paired = _iou_paired(preds, gts)
    r1 = {str(t): float(100 * np.mean(paired >= t)) for t in iou_thds}
    miou = float(100 * paired.mean())
    return r1, miou


def compute_hl_hit1(qid2preds: Dict, qid2gt_binary: Dict) -> float:
    """HIT@1: is the top-scored clip a positive under any annotator
    (eval.py:198-211)."""
    hits = []
    for qid, pred in qid2preds.items():
        idx = int(np.argmax(pred["pred_saliency_scores"]))
        gtb = qid2gt_binary[qid]  # (#clips, #annotators)
        hits.append(float(np.max(gtb[idx])) if idx < len(gtb) else 0.0)
    return float(100 * np.mean(hits))


def _binary_ap(y_true: np.ndarray, y_score: np.ndarray) -> float:
    order = np.argsort(-y_score, kind="stable")
    y = y_true[order]
    cum_tp = np.cumsum(y)
    precision = cum_tp / (np.arange(len(y)) + 1)
    npos = y.sum()
    if npos == 0:
        return 0.0
    return float(np.sum(precision * y) / npos)


def compute_hl_ap(qid2preds: Dict, qid2gt_binary: Dict) -> float:
    """Mean per-query binary AP over annotators (eval.py:213-240)."""
    aps = []
    for qid, pred in qid2preds.items():
        scores = np.asarray(pred["pred_saliency_scores"], np.float64)
        gtb = qid2gt_binary[qid]
        n = min(len(scores), len(gtb))
        for w in range(gtb.shape[1]):
            aps.append(_binary_ap(gtb[:n, w], scores[:n]))
    return float(100 * np.mean(aps)) if aps else 0.0
