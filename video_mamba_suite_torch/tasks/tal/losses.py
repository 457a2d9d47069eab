"""TAL losses: the sigmoid focal loss and the centre-offset IoU losses of
1-D segments (counterparts of the JAX package's ``tasks/tal/losses.py``),
computed in fp32."""

from __future__ import annotations

import torch


def _reduce(loss: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def sigmoid_focal_loss(inputs: torch.Tensor, targets: torch.Tensor,
                       alpha: float = 0.25, gamma: float = 2.0,
                       reduction: str = "none") -> torch.Tensor:
    """RetinaNet's focal loss on logits ``inputs`` against ``targets`` in
    [0, 1], elementwise unless ``reduction`` is "mean" or "sum"; alpha < 0
    leaves out the class weighting."""
    inputs, targets = inputs.float(), targets.float()
    p = torch.sigmoid(inputs)
    # the stable binary cross-entropy with logits
    ce = (torch.clamp(inputs, min=0) - inputs * targets
          + torch.log1p(torch.exp(-inputs.abs())))
    p_t = p * targets + (1 - p) * (1 - targets)
    loss = ce * (1 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * targets + (1 - alpha) * (1 - targets)) * loss
    return _reduce(loss, reduction)


def _iou_terms(input_offsets, target_offsets, eps):
    lp, rp = input_offsets[:, 0], input_offsets[:, 1]
    lg, rg = target_offsets[:, 0], target_offsets[:, 1]
    intsctk = torch.minimum(rp, rg) + torch.minimum(lp, lg)
    unionk = (lp + rp) + (lg + rg) - intsctk
    return lp, rp, lg, rg, intsctk / torch.clamp(unionk, min=eps)


def ctr_giou_loss_1d(input_offsets: torch.Tensor,
                     target_offsets: torch.Tensor, reduction: str = "none",
                     eps: float = 1e-8) -> torch.Tensor:
    """1 − IoU of segments given as (left, right) offsets from one centre
    (N, 2), which is their GIoU loss."""
    *_, iouk = _iou_terms(input_offsets.float(), target_offsets.float(),
                          eps)
    return _reduce(1.0 - iouk, reduction)


def ctr_diou_loss_1d(input_offsets: torch.Tensor,
                     target_offsets: torch.Tensor, reduction: str = "none",
                     eps: float = 1e-8) -> torch.Tensor:
    """Distance-IoU loss of (left, right) centre offsets (N, 2): 1 − IoU +
    (distance of the centres / length of the hull)²."""
    lp, rp, lg, rg, iouk = _iou_terms(input_offsets.float(),
                                      target_offsets.float(), eps)
    len_c = torch.maximum(lp, lg) + torch.maximum(rp, rg)
    rho = 0.5 * (rp - lp - rg + lg)
    loss = 1.0 - iouk + (rho / torch.clamp(len_c, min=eps)).square()
    return _reduce(loss, reduction)
