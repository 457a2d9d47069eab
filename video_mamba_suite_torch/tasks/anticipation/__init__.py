"""Action anticipation: LSTR-Mamba over long- and work-memory features
with anticipation queries, its streaming inference, training, metrics and
per-frame data (counterpart of the JAX package's
``tasks/anticipation``)."""

from .data import PerFrameDataset
from .metrics import marginalize, perframe_average_precision, topk_recall
from .model import FeatureHead, LSTRMamba, NormalizedLinear
from .train import (
    AnticipationTrainer,
    anticipation_loss,
    build_anticipation_trainer,
    predict,
)

__all__ = ["AnticipationTrainer", "FeatureHead", "LSTRMamba",
           "NormalizedLinear", "PerFrameDataset", "anticipation_loss",
           "build_anticipation_trainer", "marginalize",
           "perframe_average_precision", "predict", "topk_recall"]
