"""Serving a recognition model: class probabilities per clip (the JAX
``RecognitionTrainer._predict``) and multi-view evaluation (its
``evaluate``, without the trainer)."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from .engine import merge_multi_view, topk_accuracy


def predict(model: nn.Module, videos, batch_size: int = 8) -> torch.Tensor:
    """Softmax of the eval-mode logits of ``videos`` (N, T, H, W, C), a
    tensor or numpy array, run ``batch_size`` clips at a time on the
    model's device. Returns (N, num_classes) fp32 on that device. The
    model's training flag is restored afterwards."""
    device = next(model.parameters()).device
    was_training = model.training
    model.eval()
    try:
        with torch.inference_mode():
            probs = [
                torch.softmax(model(torch.as_tensor(
                    videos[i:i + batch_size]).to(device)).float(), dim=-1)
                for i in range(0, len(videos), batch_size)]
    finally:
        model.train(was_training)
    return torch.cat(probs)


def evaluate(model: nn.Module, videos, labels: np.ndarray,
             video_ids: Optional[np.ndarray] = None,
             batch_size: int = 8) -> Dict[str, float]:
    """Top-1 and top-5 accuracy (in percent) of ``predict``. Rows sharing
    a video id are one video seen from several views: their probabilities
    are averaged first, and the video's label is its first row's."""
    probs = predict(model, videos, batch_size).cpu().numpy()
    labels = np.asarray(labels)
    if video_ids is not None:
        video_ids = np.asarray(video_ids)
        uniq, merged = merge_multi_view(probs, video_ids)
        lab = np.array([labels[video_ids == u][0] for u in uniq])
        return topk_accuracy(merged, lab)
    return topk_accuracy(probs, labels)
