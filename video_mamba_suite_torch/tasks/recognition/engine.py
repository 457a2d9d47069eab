"""Test-time multi-view merging and top-k accuracy (the port's own copy of
the JAX package's ``tasks/recognition/engine.py``, numpy only): per-view
class probabilities are averaged per video, then scored top-1 and top-5.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def merge_multi_view(scores: np.ndarray, video_ids: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Average per-view class probabilities per unique video id.
    Returns (unique_ids, merged probs)."""
    uniq = np.unique(video_ids)
    merged = np.stack([scores[video_ids == u].mean(axis=0) for u in uniq])
    return uniq, merged


def topk_accuracy(probs: np.ndarray, labels: np.ndarray,
                  ks: Tuple[int, ...] = (1, 5)) -> Dict[str, float]:
    """Percentage of rows whose label is among the k most probable
    classes, for each k."""
    order = np.argsort(-probs, axis=1)
    out = {}
    for k in ks:
        hit = (order[:, :k] == labels[:, None]).any(axis=1)
        out[f"top{k}"] = float(100 * hit.mean())
    return out
