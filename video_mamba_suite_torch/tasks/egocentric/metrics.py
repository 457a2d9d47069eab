"""EK100 multi-instance retrieval metrics (mAP, nDCG) and the EK100
classification helpers: the port's numpy copy of the JAX package's
``tasks/egocentric/metrics.py`` (itself upstream's
``avion/utils/evaluation_ek100mir.py`` and ``evaluation_ek100cls.py``)."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def calculate_k_counts(relevancy_matrix: np.ndarray) -> np.ndarray:
    """Mask of the first k (= the number relevant) sorted retrievals per
    query."""
    return (np.sort(relevancy_matrix)[:, ::-1] > 0).astype(int)


def calculate_DCG(similarity_matrix, relevancy_matrix, k_counts) -> np.ndarray:
    x_sz, y_sz = similarity_matrix.shape
    ranks = np.argsort(similarity_matrix)[:, ::-1]
    logs = np.log2(np.arange(y_sz) + 2)
    divisors = np.repeat(logs[None], x_sz, axis=0)
    columns = np.repeat(np.arange(x_sz)[:, None], y_sz, axis=1)
    numerators = relevancy_matrix[columns, ranks] * k_counts
    return np.sum(numerators / divisors, axis=1)


def calculate_IDCG(relevancy_matrix, k_counts) -> np.ndarray:
    return calculate_DCG(relevancy_matrix, relevancy_matrix, k_counts)


def calculate_nDCG(similarity_matrix, relevancy_matrix, k_counts=None,
                   IDCG=None, reduction="mean"):
    if k_counts is None:
        k_counts = calculate_k_counts(relevancy_matrix)
    DCG = calculate_DCG(similarity_matrix, relevancy_matrix, k_counts)
    if IDCG is None:
        IDCG = calculate_IDCG(relevancy_matrix, k_counts)
    vals = DCG / np.maximum(IDCG, 1e-8)
    return float(np.mean(vals)) if reduction == "mean" else vals


def calculate_mAP(sim_mat: np.ndarray, relevancy_matrix: np.ndarray) -> float:
    """Mean average precision with binary relevance == 1."""
    ranked_order = (-sim_mat).argsort()
    rows = np.arange(sim_mat.shape[0])[:, None]
    ranked_rel = relevancy_matrix[rows, ranked_order]
    cumulative = np.cumsum(ranked_rel, axis=1).astype(np.float64)
    cumulative[ranked_rel != 1] = 0
    divisor = np.arange(ranked_rel.shape[1]) + 1
    n_rel = np.sum(ranked_rel == 1, axis=1)
    avg_prec = np.sum(cumulative / divisor, axis=1) / np.maximum(n_rel, 1)
    return float(np.mean(avg_prec))


def get_mAP(similarity_matrix, rel_matrix) -> Tuple[float, float, float]:
    vis = calculate_mAP(similarity_matrix, rel_matrix)
    txt = calculate_mAP(similarity_matrix.T, rel_matrix.T)
    return vis, txt, (vis + txt) / 2


def get_nDCG(similarity_matrix, rel_matrix) -> Tuple[float, float, float]:
    vk = calculate_k_counts(rel_matrix)
    tk = calculate_k_counts(rel_matrix.T)
    vi = calculate_IDCG(rel_matrix, vk)
    ti = calculate_IDCG(rel_matrix.T, tk)
    vis = calculate_nDCG(similarity_matrix, rel_matrix, vk, vi)
    txt = calculate_nDCG(similarity_matrix.T, rel_matrix.T, tk, ti)
    return vis, txt, (vis + txt) / 2


def create_relevancy_matrix(vis_classes: np.ndarray, txt_classes: np.ndarray
                            ) -> np.ndarray:
    """Binary relevancy from class agreement."""
    return (vis_classes[:, None] == txt_classes[None, :]).astype(np.float64)


def get_marginal_indexes(action_groups: np.ndarray, num_groups: int = None):
    """For each verb (or noun) id, the action ids that contain it; an empty
    group maps to [0], as upstream's does."""
    action_groups = np.asarray(action_groups)
    if num_groups is None:
        num_groups = int(action_groups.max()) + 1
    out = []
    for g in range(num_groups):
        vals = np.nonzero(action_groups == g)[0]
        out.append(vals if len(vals) else np.array([0]))
    return out


def marginalize(probs: np.ndarray, indexes) -> np.ndarray:
    """Sum action probabilities (N, num_actions) into verb or noun
    marginals (N, num_groups)."""
    return np.stack([probs[:, ilist].sum(1) for ilist in indexes], axis=1)


def get_mean_accuracy(cm: np.ndarray):
    """(per-class mean accuracy, overall accuracy) in % from a confusion
    matrix."""
    per_class = [
        cm[i, i] / cm[i, :].sum() if cm[i, :].sum() > 0 else 0.0
        for i in range(len(cm))
    ]
    return 100 * float(np.mean(per_class)), 100 * float(
        np.trace(cm) / max(np.sum(cm), 1))
