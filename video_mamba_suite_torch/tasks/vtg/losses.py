"""UniVTG losses (the port's counterpart of the JAX package's
``tasks/vtg/losses.py``): the span smooth-L1 and generalized-IoU terms,
the weighted foreground BCE, and the inter- and intra-video saliency
InfoNCE terms, with their weighted total. Plain torch on the model's
outputs, in fp32."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .model import cosine

VTG_LOSS_WEIGHTS = dict(loss_b=10.0, loss_g=1.0, loss_f=10.0,
                        loss_s_inter=0.1, loss_s_intra=0.1)


def smooth_l1(x: torch.Tensor, y: torch.Tensor,
              beta: float = 1.0) -> torch.Tensor:
    d = (x - y).abs()
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)


def generalized_temporal_iou(spans1: torch.Tensor, spans2: torch.Tensor,
                             eps: float = 1e-6) -> torch.Tensor:
    """The gIoU of each (start, end) span of spans1 (N, 2) with the span
    of spans2 (N, 2) in the same row."""
    s1, e1 = spans1[:, 0], spans1[:, 1]
    s2, e2 = spans2[:, 0], spans2[:, 1]
    inter = (torch.minimum(e1, e2) - torch.maximum(s1, s2)).clamp_min(0)
    union = (e1 - s1) + (e2 - s2) - inter
    iou = inter / union.clamp_min(eps)
    hull = torch.maximum(e1, e2) - torch.minimum(s1, s2)
    return iou - (hull - union) / hull.clamp_min(eps)


def unit_rows(x: torch.Tensor) -> torch.Tensor:
    """x over sqrt(Σx² + 1e-8) along the last axis."""
    return x / torch.sqrt((x * x).sum(dim=-1, keepdim=True) + 1e-8)


def weighted_bce(probs: torch.Tensor, tgt: torch.Tensor, mask: torch.Tensor,
                 eos_coef: float) -> torch.Tensor:
    """The BCE of probabilities clipped to [1e-6, 1 - 1e-6], weighted 1 on
    foreground and ``eos_coef`` on background, times ``mask``."""
    probs = probs.float().clamp(1e-6, 1 - 1e-6)
    w = torch.where(tgt > 0, 1.0, eos_coef) * mask
    return -(tgt * torch.log(probs) + (1 - tgt) * torch.log(1 - probs)) * w


def vtg_losses(outputs: Dict[str, torch.Tensor],
               targets: Dict[str, torch.Tensor], eos_coef: float = 0.1,
               temperature: float = 0.07,
               weights: Optional[Dict[str, float]] = None
               ) -> Dict[str, torch.Tensor]:
    """loss_b (span smooth-L1), loss_g (1 - gIoU), loss_f (foreground
    BCE), loss_s_inter and loss_s_intra (saliency InfoNCE), and
    loss_total, their sum under ``weights`` (default
    ``VTG_LOSS_WEIGHTS``).

    targets: timestamp (B, Lv, 2), timestamp_mask (B, Lv),
    timestamp_window (B, Lv), span_labels_nn (B, Lv, 2),
    saliency_pos_labels (B,) integers, saliency_scores (B, Lv). The intra
    term masks with a finite -1e4 (as the JAX package; the reference's
    log(mask + 1e-45) is -inf under flushed subnormals)."""
    weights = weights or VTG_LOSS_WEIGHTS
    out: Dict[str, torch.Tensor] = {}

    src_spans = targets["timestamp"].float() + outputs["pred_spans"].float()
    gt_spans = targets["span_labels_nn"].float()
    mask_valid = targets["timestamp_window"].float()
    n_valid = mask_valid.sum().clamp_min(1.0)
    l1 = smooth_l1(src_spans, gt_spans) * mask_valid[..., None]
    out["loss_b"] = l1.sum() / n_valid
    giou = generalized_temporal_iou(
        src_spans.reshape(-1, 2), gt_spans.reshape(-1, 2)
    ).reshape(mask_valid.shape)
    out["loss_g"] = ((1.0 - giou) * mask_valid).sum() / n_valid

    mask = targets["timestamp_mask"].float()
    bce = weighted_bce(outputs["pred_logits"][..., 0], mask_valid, mask,
                       eos_coef)
    out["loss_f"] = (bce * mask).sum() / mask.sum().clamp_min(1.0)

    vid_mem = outputs["vid_mem_proj"].float()                  # (B, Lv, D)
    txt_feats = outputs["txt_mem_proj"][:, 0].float()          # (B, D)
    pos_idx = targets["saliency_pos_labels"].long()            # (B,)
    bidx = torch.arange(vid_mem.shape[0], device=vid_mem.device)
    vid_feats = vid_mem[bidx, pos_idx]                         # (B, D)
    sim = unit_rows(vid_feats) @ unit_rows(txt_feats).T        # (B, B)
    i_logsm = torch.log_softmax(sim / temperature, dim=1)
    j_logsm = torch.log_softmax(sim.T / temperature, dim=1)
    out["loss_s_inter"] = -(i_logsm.diagonal().mean()
                            + j_logsm.diagonal().mean())

    sal = targets["saliency_scores"].float()                   # (B, Lv)
    sel = sal[bidx, pos_idx][:, None]
    neg_in = sal < sel
    neg_in[bidx, pos_idx] = True
    keep = neg_in & (mask > 0)
    sim_in = cosine(vid_mem, txt_feats[:, None]) + torch.where(keep, 0.0,
                                                               -1e4)
    logsm_i = torch.log_softmax(sim_in / temperature, dim=1)
    logsm_j = torch.log_softmax(sim_in.T / temperature, dim=1)
    out["loss_s_intra"] = -(logsm_i[bidx, pos_idx].mean()
                            + logsm_j[pos_idx, bidx].mean())

    out["loss_total"] = sum(out[k] * weights.get(k, 1.0) for k in list(out))
    return out
