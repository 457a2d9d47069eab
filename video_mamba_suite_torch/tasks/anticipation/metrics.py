"""Anticipation metrics (the port's own copy of the JAX package's
``tasks/anticipation/metrics.py``, numpy only): per-frame average
precision over classes (the background class excluded), class-mean top-k
recall (EK100's "overall recall"), and marginalising action scores to verb
or noun scores."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def _binary_ap(y_true: np.ndarray, y_score: np.ndarray) -> float:
    order = np.argsort(-y_score, kind="stable")
    y = y_true[order]
    npos = y.sum()
    if npos == 0:
        return float("nan")
    precision = np.cumsum(y) / (np.arange(len(y)) + 1)
    return float(np.sum(precision * y) / npos)


def perframe_average_precision(scores: np.ndarray, labels: np.ndarray,
                               ignore_index: Optional[int] = 0) -> Dict:
    """scores (N, C) probabilities, labels (N,) int → {"per_class_AP":
    {class: AP} over the classes present, "mean_AP": their mean (0 when
    none)}, class ``ignore_index`` left out."""
    aps = {}
    for c in range(scores.shape[1]):
        if ignore_index is not None and c == ignore_index:
            continue
        ap = _binary_ap((labels == c).astype(np.float64), scores[:, c])
        if not np.isnan(ap):
            aps[c] = ap
    mean_ap = float(np.mean(list(aps.values()))) if aps else 0.0
    return {"per_class_AP": aps, "mean_AP": mean_ap}


def topk_recall(scores: np.ndarray, labels: np.ndarray, k: int = 5) -> float:
    """Class-mean top-k recall in percent: for each class in ``labels``,
    the share of its instances whose label is among the top-k scores."""
    topk = np.argsort(-scores, axis=1)[:, :k]
    hit = (topk == labels[:, None]).any(axis=1)
    recalls = [hit[labels == c].mean() for c in np.unique(labels)]
    return float(100 * np.mean(recalls))


def marginalize(scores_action: np.ndarray, action_to_group: np.ndarray,
                num_groups: int) -> np.ndarray:
    """Action scores (N, A) summed into verb or noun scores (N, num_groups)
    through the action → group map (A,)."""
    out = np.zeros((scores_action.shape[0], num_groups), scores_action.dtype)
    for a, g in enumerate(action_to_group):
        out[:, g] += scores_action[:, a]
    return out
