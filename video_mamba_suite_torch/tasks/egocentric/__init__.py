"""Egocentric understanding with the CLIP dual encoder: EK100
multi-instance retrieval serving, its metrics, and EgoSchema zero-shot
QA (counterpart of the JAX package's ``tasks/egocentric``)."""

from .egoschema import egoschema_zero_shot
from .finetune import MirFinetuner, build_clip_mir
from .metrics import (
    calculate_mAP,
    calculate_nDCG,
    create_relevancy_matrix,
    get_mAP,
    get_nDCG,
)

__all__ = ["MirFinetuner", "build_clip_mir", "calculate_mAP",
           "calculate_nDCG", "create_relevancy_matrix", "egoschema_zero_shot",
           "get_mAP", "get_nDCG"]
