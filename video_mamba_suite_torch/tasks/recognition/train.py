"""Kinetics-400 fine-tuning of ViViM (the port's ``RecognitionTrainer``,
counterpart of the JAX package's ``tasks/recognition/train.py``): mixup /
cutmix with label smoothing, soft-target cross-entropy, drop-path, the
optax chain clip-by-global-norm → layer decay → AdamW under a warmup-cosine
schedule, and an EMA of the parameters.

    trainer = build_vivim_k400_trainer()          # ViViM-T on the card
    loss = trainer.train_step(videos, labels)     # (B, T, H, W, C), (B,)

On the card each mixer's scans run K3 forward (writing checkpoints) and K4
backward. ``save`` / ``restore`` checkpoint the trainer's whole state
through its ``TrainerCore``.
"""

from __future__ import annotations

import inspect
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ...utils.ema import ModelEma
from ...utils.optim import chain_step, make_optimizer
from ...utils.schedules import lambda_lr, make_schedule
from ...utils.trainer import (
    Checkpointing,
    TrainerCore,
    load_generator_state,
)
from .augment import mixup_cutmix, one_hot_smooth
from .optim import layer_decay_param_groups
from .serve import evaluate

GRAD_CLIP = 1.0   # the chain's global-norm bound (the JAX trainer's)


def soft_target_cross_entropy(logits: torch.Tensor,
                              targets: torch.Tensor) -> torch.Tensor:
    """timm's SoftTargetCrossEntropy (used with mixup), logits in fp32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.mean(torch.sum(targets * logp, dim=-1))


class RecognitionTrainer(Checkpointing):
    """Fine-tunes a ViViM classifier (``model.head`` with ``num_classes``
    outputs) with the JAX trainer's recipe and defaults.

    The trainer owns two generators seeded with ``seed``: one on the CPU
    for the mixup / cutmix draws and one on the model's device for the
    drop-path masks. ``use_mesh`` raises, as ``TrainerCore`` does."""

    def __init__(self, model: nn.Module, num_classes: int, lr: float = 1e-3,
                 weight_decay: float = 0.05, layer_decay: float = 0.75,
                 warmup_steps: int = 100, total_steps: int = 10000,
                 mixup_alpha: float = 0.8, cutmix_alpha: float = 1.0,
                 smoothing: float = 0.1, ema_decay: float = 0.9999,
                 seed: int = 0, use_mesh: bool = False):
        if model.head is None or model.head.weight.shape[0] != num_classes:
            raise ValueError(f"the model has no {num_classes}-class head")
        self.model = model
        self.num_classes = num_classes
        self.mixup_alpha = mixup_alpha
        self.cutmix_alpha = cutmix_alpha
        self.smoothing = smoothing
        self.device = next(model.parameters()).device
        self.core = TrainerCore(use_mesh=use_mesh, device=self.device)
        self.generator = torch.Generator().manual_seed(seed)
        self.drop_generator = torch.Generator(
            device=self.device).manual_seed(seed)
        self.schedule = make_schedule("cosine", lr, total_steps,
                                      warmup_steps)
        self.optimizer = make_optimizer(model, "adamw", lr=lr,
                                        weight_decay=weight_decay,
                                        use_mask=True)
        self.lr_scheduler = lambda_lr(self.optimizer, self.schedule)
        self.grad_scales: Dict[str, float] = {}
        if layer_decay and layer_decay < 1.0:
            self.grad_scales = layer_decay_param_groups(model, model.depth,
                                                        layer_decay)
        self.ema = ModelEma(model, ema_decay)

    def train_step(self, videos, labels) -> float:
        """One step on a batch: videos (B, T, H, W, C) and int labels (B,),
        tensors or numpy arrays. Returns the loss before the update (reading
        it waits for the device)."""
        videos = torch.as_tensor(videos).to(self.device)
        labels = torch.as_tensor(labels).to(self.device)
        if self.mixup_alpha > 0 or self.cutmix_alpha > 0:
            videos, targets = mixup_cutmix(
                self.generator, videos, labels, self.num_classes,
                self.mixup_alpha, self.cutmix_alpha,
                smoothing=self.smoothing)
        else:
            targets = one_hot_smooth(labels, self.num_classes,
                                     self.smoothing)
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        logits = self.model(videos, generator=self.drop_generator)
        loss = soft_target_cross_entropy(logits, targets)
        loss.backward()
        chain_step(self.optimizer, self.model.named_parameters(),
                   self.grad_scales, GRAD_CLIP)
        self.lr_scheduler.step()
        self.ema.update(self.model)
        return float(loss.detach())

    def evaluate(self, videos, labels: np.ndarray,
                 video_ids: Optional[np.ndarray] = None,
                 batch_size: int = 8,
                 use_ema: bool = False) -> Dict[str, float]:
        """Top-1 / top-5 (multi-view when ``video_ids`` is given) of the
        model, or of its EMA with ``use_ema``."""
        if not use_ema:
            return evaluate(self.model, videos, labels, video_ids,
                            batch_size)
        params = [p.detach().clone() for p in self.model.parameters()]
        self.ema.copy_to(self.model)
        try:
            return evaluate(self.model, videos, labels, video_ids,
                            batch_size)
        finally:
            with torch.no_grad():
                for p, saved in zip(self.model.parameters(), params):
                    p.copy_(saved)

    def state_dict(self) -> dict:
        """Parameters, optimizer and schedule state, EMA and both
        generators' states."""
        return dict(model=self.model.state_dict(),
                    optimizer=self.optimizer.state_dict(),
                    lr_scheduler=self.lr_scheduler.state_dict(),
                    ema=self.ema.state_dict(),
                    generator=self.generator.get_state(),
                    drop_generator=self.drop_generator.get_state())

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.lr_scheduler.load_state_dict(state["lr_scheduler"])
        self.ema.load_state_dict(state["ema"])
        load_generator_state(self.generator, state["generator"])
        load_generator_state(self.drop_generator, state["drop_generator"])


def build_vivim_k400_trainer(device="cuda", seed: int = 0, **overrides
                             ) -> RecognitionTrainer:
    """ViViM-T for Kinetics-400 with random weights from ``seed`` and its
    trainer at the preset's values (``configs.VIVIM_T_K400`` and
    ``configs.VIVIM_T_K400_FINETUNE``). ``overrides`` change a trainer
    argument (``lr``, ``warmup_steps``, ...) or, otherwise, a model
    argument (``depth``, ``drop_path_rate``, ...)."""
    from ...configs import VIVIM_T_K400, VIVIM_T_K400_FINETUNE
    from ...models.vivim import build_vivim_tiny_k400

    known = set(inspect.signature(RecognitionTrainer).parameters)
    train_kw = dict(VIVIM_T_K400_FINETUNE, seed=seed)
    train_kw.update({k: v for k, v in overrides.items() if k in known})
    model_kw = {k: v for k, v in overrides.items() if k not in known}
    model = build_vivim_tiny_k400(device=device, seed=seed, **model_kw)
    return RecognitionTrainer(model, VIVIM_T_K400["num_classes"], **train_kw)
