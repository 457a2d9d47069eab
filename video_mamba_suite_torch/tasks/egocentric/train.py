"""CLIP pretraining of the egocentric dual encoder (the port's counterpart
of the JAX package's ``tasks/egocentric/train.py``): the symmetric InfoNCE
of ``clip_loss`` over the batch, AdamW (b2 0.98) under a warmup-cosine
schedule, clip 1.0, dropout and drop-path masks from a generator on the
model's device; ``save`` / ``restore`` checkpoint the trainer's whole
state.

    trainer = build_clip_pretrainer()             # on the card
    loss = trainer.train_step(videos, token_ids)  # (B, T, H, W, 3), (B, L)
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ...configs import EGO_TIMEMAMBA_PRETRAIN
from ...models.clip import CLIP
from ...utils.trainer import TrainerCore
from .finetune import _AdamWTrainer, _clip, _device
from .losses import clip_loss


class ClipPretrainer(_AdamWTrainer):
    """Contrastive pretraining of a ``CLIP``: ``train_step`` on a batch of
    clips and their captions, ``encode`` the embeddings and the scale."""

    def __init__(self, model: CLIP, lr: float = 3e-5,
                 weight_decay: float = 0.01, warmup_steps: int = 100,
                 total_steps: int = 10000, grad_clip: float = 1.0,
                 use_mesh: bool = False, seed: int = 0):
        self.model = model
        self.generator = torch.Generator(
            device=_device(model)).manual_seed(seed)
        self._build_optimizer(lr, weight_decay, warmup_steps, total_steps,
                              grad_clip, 0.98)
        self.core = TrainerCore(use_mesh=use_mesh, device=_device(model))

    def train_step(self, videos, texts) -> float:
        """One step on clips (B, T, H, W, 3) and their captions' token ids
        (B, L), tensors or numpy arrays; caption i describes clip i.
        Returns the loss before the update."""
        device = _device(self.model)
        videos = torch.as_tensor(videos).to(device=device,
                                            dtype=torch.float32)
        texts = torch.as_tensor(texts).to(device=device, dtype=torch.long)
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        img, txt, scale = self.model(videos, texts, generator=self.generator)
        return self._update(clip_loss(img, txt, scale))

    def encode(self, videos, texts) -> Tuple[np.ndarray, np.ndarray, float]:
        """(video embeddings, text embeddings) as numpy fp32 and the scale
        exp(logit_scale), in eval mode under inference mode."""
        device = _device(self.model)
        was_training = self.model.training
        self.model.eval()
        with torch.inference_mode():
            img, txt, scale = self.model(
                torch.as_tensor(videos).to(device=device,
                                           dtype=torch.float32),
                torch.as_tensor(texts).to(device=device, dtype=torch.long))
        self.model.train(was_training)
        return img.cpu().numpy(), txt.cpu().numpy(), float(scale)


def build_clip_pretrainer(config=EGO_TIMEMAMBA_PRETRAIN, device="cuda",
                          seed: int = 0, attn_flash=None,
                          vision_dtype: Optional[torch.dtype] = None,
                          **trainer_kw) -> ClipPretrainer:
    """A ``ClipPretrainer`` holding the ``CLIP`` of ``config`` (default the
    Ego4D pretraining preset: CLIP-TimeMamba-B at 4 frames, frozen-in-time,
    tanh gates, embeddings of 512) with random weights from ``seed``, on
    ``device`` ("cuda" unless the caller asks for "cpu"), and the preset's
    recipe (``config["opt"]``: lr, weight decay). ``attn_flash`` is the video tower's spatial
    attention kernel (None: the einsum path; "row": K10) and
    ``vision_dtype`` its compute dtype (None: fp32); the text tower runs in
    fp32. ``trainer_kw`` overrides the trainer's arguments."""
    model = _clip(config, device, seed, attn_flash, vision_dtype)
    kw = dict(config["opt"], seed=seed)
    kw.update(trainer_kw)
    return ClipPretrainer(model, **kw)
