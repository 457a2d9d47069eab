"""Temporal action localization: ActionMamba, its losses, label
assignment, decode, NMS, mAP, data and trainer (counterpart of the JAX
package's ``tasks/tal``)."""

from .data import TalDataset, collate_tal, make_synthetic_tal, truncate_feats
from .losses import ctr_diou_loss_1d, ctr_giou_loss_1d, sigmoid_focal_loss
from .metrics import ANETdetection
from .model import (
    ActionMambaDetector,
    ConvHead,
    FPN1D,
    FPNIdentity,
    MambaBackbone,
    PointGenerator,
    Scale,
    decode_single_video,
    label_points,
    tal_losses,
)
from .nms import (
    batched_nms,
    nms_1d,
    nms_1d_ref,
    seg_voting,
    soft_nms_1d,
    soft_nms_1d_ref,
)
from .train import TalTrainer, build_tal_trainer, fuse_external_scores

__all__ = [
    "ANETdetection", "ActionMambaDetector", "ConvHead", "FPN1D",
    "FPNIdentity", "MambaBackbone", "PointGenerator", "Scale",
    "TalDataset", "TalTrainer", "batched_nms", "build_tal_trainer",
    "collate_tal", "ctr_diou_loss_1d", "ctr_giou_loss_1d",
    "decode_single_video", "fuse_external_scores", "label_points",
    "make_synthetic_tal", "nms_1d", "nms_1d_ref", "seg_voting",
    "sigmoid_focal_loss", "soft_nms_1d", "soft_nms_1d_ref", "tal_losses",
    "truncate_feats",
]
