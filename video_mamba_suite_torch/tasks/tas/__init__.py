"""Temporal action segmentation: ASFormer-Mamba (``MaTransformer``), its
loss, trainer, frame metrics and data (counterpart of the JAX package's
``tasks/tas``)."""

from .data import (
    IGNORE_INDEX,
    TasBatchGenerator,
    collate,
    make_synthetic_dataset,
    time_warp,
)
from .metrics import (
    accuracy,
    edit_score,
    evaluate_segmentation,
    f_score,
    get_labels_start_end_time,
    levenstein,
)
from .model import (
    AttnAttModule,
    ConvFeedForward,
    MambaAttModule,
    MaTransformer,
    TasDecoder,
    TasEncoder,
    exponential_descrease,
)
from .train import TasTrainer, build_tas_trainer, tas_loss

__all__ = [
    "AttnAttModule", "ConvFeedForward", "IGNORE_INDEX", "MaTransformer",
    "MambaAttModule", "TasBatchGenerator", "TasDecoder", "TasEncoder",
    "TasTrainer", "accuracy", "build_tas_trainer", "collate", "edit_score",
    "evaluate_segmentation", "exponential_descrease", "f_score",
    "get_labels_start_end_time", "levenstein", "make_synthetic_dataset",
    "tas_loss", "time_warp",
]
