"""PDVC's Hungarian matcher (the port's counterpart of the JAX package's
``tasks/captioning/matcher.py``): the cost of every (query, event) pair
on the device, a focal class cost + L1 of (center, length) + 1-D gIoU;
the assignment on the host by scipy's ``linear_sum_assignment``, from one
copy of the (B, Q, G) cost."""

from __future__ import annotations

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment


def cl_to_se(boxes: torch.Tensor) -> torch.Tensor:
    """(center, length) → (start, end)."""
    c, l = boxes[..., 0], boxes[..., 1]
    return torch.stack([c - 0.5 * l, c + 0.5 * l], dim=-1)


def giou_1d(a_se: torch.Tensor, b_se: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """Pairwise gIoU of (..., N, 2) and (..., M, 2) start/end spans →
    (..., N, M)."""
    s1, e1 = a_se[..., :, None, 0], a_se[..., :, None, 1]
    s2, e2 = b_se[..., None, :, 0], b_se[..., None, :, 1]
    return _giou(s1, e1, s2, e2, eps)


def _giou(s1, e1, s2, e2, eps):
    inter = (torch.minimum(e1, e2) - torch.maximum(s1, s2)).clamp(min=0)
    union = (e1 - s1) + (e2 - s2) - inter
    iou = inter / union.clamp(min=eps)
    hull = torch.maximum(e1, e2) - torch.minimum(s1, s2)
    return iou - (hull - union) / hull.clamp(min=eps)


def paired_giou_1d(a_se: torch.Tensor, b_se: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """gIoU of matching rows of (..., 2) start/end spans (the diagonal of
    ``giou_1d``)."""
    return _giou(a_se[..., 0], a_se[..., 1], b_se[..., 0], b_se[..., 1], eps)


def match_cost(pred_logits, pred_boxes, gt_labels, gt_boxes, gt_valid,
               cost_class: float = 2.0, cost_bbox: float = 5.0,
               cost_giou: float = 2.0, alpha: float = 0.25,
               gamma: float = 2.0) -> torch.Tensor:
    """The cost (..., Q, G) of (..., Q, C) logits and (..., Q, 2) boxes
    against (..., G) labels, (..., G, 2) boxes and (..., G) validity: the
    focal cost (positive minus negative at the event's class) + L1 +
    −gIoU, weighted; 1e6 at invalid events."""
    prob = torch.sigmoid(pred_logits)
    neg = (1 - alpha) * (prob ** gamma) * (-torch.log1p(-prob + 1e-8))
    pos = alpha * ((1 - prob) ** gamma) * (-torch.log(prob + 1e-8))
    labels = gt_labels.long()[..., None, :].expand(
        *prob.shape[:-1], gt_labels.shape[-1])
    cost_cls = pos.gather(-1, labels) - neg.gather(-1, labels)
    cost_l1 = (pred_boxes[..., :, None, :]
               - gt_boxes[..., None, :, :]).abs().sum(dim=-1)
    cost_g = -giou_1d(cl_to_se(pred_boxes), cl_to_se(gt_boxes))
    cost = cost_class * cost_cls + cost_bbox * cost_l1 + cost_giou * cost_g
    return torch.where(gt_valid[..., None, :].bool(), cost, 1e6)


def host_lsa(cost: np.ndarray, n_valid: np.ndarray) -> np.ndarray:
    """The assignment of each video's first ``n_valid`` events: (B, G)
    query index per event, −1 past them."""
    B, Q, G = cost.shape
    out = np.full((B, G), -1, np.int32)
    for b in range(B):
        g = int(n_valid[b])
        if g == 0:
            continue
        rows, cols = linear_sum_assignment(cost[b, :, :g])
        out[b, cols] = rows.astype(np.int32)
    return out


def hungarian_match(cost: torch.Tensor, n_valid) -> torch.Tensor:
    """cost (B, Q, G) → (B, G) matched query index per event (−1 for
    padding) on the cost's device: one copy of the cost to the host,
    ``host_lsa``, one copy back."""
    idx = host_lsa(cost.detach().float().cpu().numpy(), np.asarray(n_valid))
    return torch.from_numpy(idx).long().to(cost.device)
