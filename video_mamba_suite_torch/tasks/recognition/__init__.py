"""Action recognition: serving a ViViM classifier, multi-view evaluation
and fine-tuning (counterpart of the JAX package's ``tasks/recognition``)."""

from .augment import (
    MixDraw,
    apply_mixup_cutmix,
    draw_mixup_cutmix,
    mixup_cutmix,
    one_hot_smooth,
)
from .engine import merge_multi_view, topk_accuracy
from .optim import layer_decay_param_groups
from .serve import evaluate, predict
from .train import (
    RecognitionTrainer,
    build_vivim_k400_trainer,
    soft_target_cross_entropy,
)

__all__ = ["MixDraw", "RecognitionTrainer", "apply_mixup_cutmix",
           "build_vivim_k400_trainer", "draw_mixup_cutmix", "evaluate",
           "layer_decay_param_groups", "merge_multi_view", "mixup_cutmix",
           "one_hot_smooth", "predict", "soft_target_cross_entropy",
           "topk_accuracy"]
