"""Egocentric understanding with the CLIP dual encoder: CLIP pretraining,
EK100 multi-instance retrieval and action-classification fine-tuning,
their losses and metrics, and EgoSchema zero-shot QA (counterpart of the
JAX package's ``tasks/egocentric``)."""

from .egoschema import egoschema_zero_shot
from .finetune import (
    ClsFinetuner,
    MirFinetuner,
    VideoClassifier,
    build_clip_mir,
    build_ek100_cls,
)
from .losses import clip_loss, max_margin_ranking_loss
from .metrics import (
    calculate_mAP,
    calculate_nDCG,
    create_relevancy_matrix,
    get_mAP,
    get_marginal_indexes,
    get_nDCG,
    marginalize,
)
from .train import ClipPretrainer, build_clip_pretrainer

__all__ = ["ClipPretrainer", "ClsFinetuner", "MirFinetuner",
           "VideoClassifier", "build_clip_mir", "build_clip_pretrainer",
           "build_ek100_cls", "calculate_mAP", "calculate_nDCG",
           "clip_loss", "create_relevancy_matrix", "egoschema_zero_shot",
           "get_mAP", "get_marginal_indexes", "get_nDCG",
           "marginalize", "max_margin_ranking_loss"]
