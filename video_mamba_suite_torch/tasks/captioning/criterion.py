"""PDVC's set criterion (the port's counterpart of the JAX package's
``tasks/captioning/criterion.py``): the focal label loss over all
queries with each matched query's event class as its target, L1 and
gIoU of the matched boxes, the event count's cross-entropy, and the
caption cross-entropy of the matched queries; in fp32."""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..tal.losses import sigmoid_focal_loss
from .matcher import cl_to_se, paired_giou_1d


def pdvc_losses(
    outputs: Dict,
    gt_boxes: torch.Tensor,       # (B, G, 2) center/length, normalized
    gt_labels: torch.Tensor,      # (B, G) int
    gt_valid: torch.Tensor,       # (B, G) bool
    match_idx: torch.Tensor,      # (B, G) query index per event, −1 none
    caption_logits: Optional[torch.Tensor] = None,   # (B, G, L, V)
    caption_targets: Optional[torch.Tensor] = None,  # (B, G, L), −100 pad
    count_weight: float = 0.5,
    bbox_weight: float = 5.0,
    giou_weight: float = 2.0,
    label_weight: float = 2.0,
    caption_weight: float = 1.0,
) -> Dict[str, torch.Tensor]:
    """loss_label, loss_bbox, loss_giou (each over the matched events of
    the whole batch, at least 1), loss_count (mean over the videos),
    loss_caption (over the valid caption tokens of matched events) when
    caption logits come, and their weighted sum loss_total."""
    logits = outputs["pred_logits"]
    boxes = outputs["pred_boxes"]
    B, Q, C = logits.shape
    gt_valid = gt_valid.bool()
    valid = gt_valid & (match_idx >= 0)
    safe_idx = match_idx.clamp(0, Q - 1)
    num_pos = valid.sum().clamp(min=1).float()

    # labels: one-hot targets added at the matched queries, then clipped
    onehot = F.one_hot(gt_labels.long(), C).float() * valid[..., None]
    tgt_cls = torch.zeros(B, Q, C, device=logits.device).scatter_add(
        1, safe_idx[..., None].expand(B, -1, C), onehot).clamp(0.0, 1.0)
    loss_label = sigmoid_focal_loss(logits, tgt_cls).sum() / num_pos

    matched = boxes.gather(1, safe_idx[..., None].expand(B, -1, 2))
    l1 = (matched - gt_boxes).abs().sum(dim=-1)
    loss_bbox = (l1 * valid).sum() / num_pos
    g = paired_giou_1d(cl_to_se(matched), cl_to_se(gt_boxes))
    loss_giou = ((1.0 - g) * valid).sum() / num_pos

    n_count = outputs["pred_count"].shape[-1]
    counts = gt_valid.sum(dim=1).clamp(0, n_count - 1)
    logp = torch.log_softmax(outputs["pred_count"].float(), dim=-1)
    loss_count = -logp.gather(1, counts[:, None]).mean()

    out = dict(loss_label=loss_label, loss_bbox=loss_bbox,
               loss_giou=loss_giou, loss_count=loss_count)
    total = (label_weight * loss_label + bbox_weight * loss_bbox
             + giou_weight * loss_giou + count_weight * loss_count)
    if caption_logits is not None:
        cap_valid = (caption_targets != -100) & valid[..., None]
        safe_t = torch.where(cap_valid, caption_targets, 0).long()
        logp_c = torch.log_softmax(caption_logits.float(), dim=-1)
        ce = -logp_c.gather(-1, safe_t[..., None])[..., 0]
        out["loss_caption"] = (ce * cap_valid).sum() / cap_valid.sum(
        ).clamp(min=1)
        total = total + caption_weight * out["loss_caption"]
    out["loss_total"] = total
    return out
