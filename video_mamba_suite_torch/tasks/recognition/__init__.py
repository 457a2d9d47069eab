"""Action recognition: serving a ViViM classifier and multi-view
evaluation (counterpart of the JAX package's ``tasks/recognition``; the
trainer is not ported yet)."""

from .engine import merge_multi_view, topk_accuracy
from .serve import evaluate, predict

__all__ = ["evaluate", "merge_multi_view", "predict", "topk_accuracy"]
