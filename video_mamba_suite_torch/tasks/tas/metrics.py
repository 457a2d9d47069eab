"""Frame accuracy, segmental edit score and F1@k for action segmentation
(the port's own copy of the JAX package's ``tasks/tas/metrics.py``, host
numpy): run-length segments, Levenshtein distance over their labels, and
IoU-matched segment F1."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def get_labels_start_end_time(
    frame_wise_labels: Sequence, bg_class: Sequence = ("background",)
) -> Tuple[List, List[int], List[int]]:
    """Run-length decode frame labels into (labels, starts, ends), the
    background class left out."""
    labels, starts, ends = [], [], []
    last_label = frame_wise_labels[0]
    if frame_wise_labels[0] not in bg_class:
        labels.append(frame_wise_labels[0])
        starts.append(0)
    for i in range(len(frame_wise_labels)):
        if frame_wise_labels[i] != last_label:
            if frame_wise_labels[i] not in bg_class:
                labels.append(frame_wise_labels[i])
                starts.append(i)
            if last_label not in bg_class:
                ends.append(i)
            last_label = frame_wise_labels[i]
    if last_label not in bg_class:
        ends.append(len(frame_wise_labels))
    return labels, starts, ends


def levenstein(p: Sequence, y: Sequence, norm: bool = False) -> float:
    """Edit distance between two segment label sequences; with ``norm``,
    100 · (1 − distance / the longer length)."""
    m_row, n_col = len(p), len(y)
    D = np.zeros((m_row + 1, n_col + 1), np.float64)
    D[:, 0] = np.arange(m_row + 1)
    D[0, :] = np.arange(n_col + 1)
    for j in range(1, n_col + 1):
        for i in range(1, m_row + 1):
            if y[j - 1] == p[i - 1]:
                D[i, j] = D[i - 1, j - 1]
            else:
                D[i, j] = min(D[i - 1, j] + 1, D[i, j - 1] + 1,
                              D[i - 1, j - 1] + 1)
    if norm:
        return (1 - D[-1, -1] / max(m_row, n_col, 1)) * 100
    return float(D[-1, -1])


def edit_score(recognized, ground_truth, norm=True,
               bg_class=("background",)) -> float:
    P, _, _ = get_labels_start_end_time(recognized, bg_class)
    Y, _, _ = get_labels_start_end_time(ground_truth, bg_class)
    return levenstein(P, Y, norm)


def f_score(recognized, ground_truth, overlap: float,
            bg_class=("background",)) -> Tuple[float, float, float]:
    """(true positives, false positives, false negatives) of the predicted
    segments matched to the ground truth's at IoU ``overlap``."""
    p_label, p_start, p_end = get_labels_start_end_time(recognized, bg_class)
    y_label, y_start, y_end = get_labels_start_end_time(ground_truth,
                                                        bg_class)
    tp, fp = 0, 0
    hits = np.zeros(len(y_label))
    y_start_a, y_end_a = np.array(y_start), np.array(y_end)
    for j in range(len(p_label)):
        if len(y_label) == 0:
            fp += 1
            continue
        inter = np.minimum(p_end[j], y_end_a) - np.maximum(p_start[j],
                                                           y_start_a)
        union = np.maximum(p_end[j], y_end_a) - np.minimum(p_start[j],
                                                           y_start_a)
        iou = (1.0 * inter / np.maximum(union, 1e-8)) * np.array(
            [p_label[j] == y_label[x] for x in range(len(y_label))])
        idx = int(np.argmax(iou))
        if iou[idx] >= overlap and not hits[idx]:
            tp += 1
            hits[idx] = 1
        else:
            fp += 1
    fn = len(y_label) - hits.sum()
    return float(tp), float(fp), float(fn)


def accuracy(recognized, ground_truth) -> float:
    return float((np.asarray(recognized) == np.asarray(ground_truth)).mean()
                 ) * 100


def evaluate_segmentation(all_preds, all_gts,
                          overlaps=(0.1, 0.25, 0.5)) -> dict:
    """Frame accuracy over every frame, the mean edit score over the
    videos, and F1 at each overlap from the summed counts: {"acc", "edit",
    "F1@10", "F1@25", "F1@50"}, in percent."""
    correct = total = 0
    edit_sum = 0.0
    tp = np.zeros(len(overlaps))
    fp = np.zeros(len(overlaps))
    fn = np.zeros(len(overlaps))
    for pred, gt in zip(all_preds, all_gts):
        pred = list(np.asarray(pred))
        gt = list(np.asarray(gt))
        correct += int((np.asarray(pred) == np.asarray(gt)).sum())
        total += len(gt)
        edit_sum += edit_score(pred, gt)
        for s, ov in enumerate(overlaps):
            tp1, fp1, fn1 = f_score(pred, gt, ov)
            tp[s] += tp1
            fp[s] += fp1
            fn[s] += fn1
    out = {"acc": 100.0 * correct / max(total, 1),
           "edit": edit_sum / max(len(all_preds), 1)}
    for s, ov in enumerate(overlaps):
        precision = tp[s] / max(tp[s] + fp[s], 1e-8)
        recall = tp[s] / max(tp[s] + fn[s], 1e-8)
        f1 = 2 * precision * recall / max(precision + recall, 1e-8)
        out[f"F1@{int(ov * 100)}"] = 100.0 * f1
    return out
