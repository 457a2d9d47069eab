"""Training and serving the anticipation model (the port's
``AnticipationTrainer``, counterpart of the JAX package's
``tasks/anticipation/train.py``): per-position cross-entropy over the work
and anticipation positions, AdamW under a warmup-cosine schedule, softmax
scores, per-frame mAP and top-5 recall.

    trainer = build_anticipation_trainer(configs.ANTICIPATION_EK100)
    loss = trainer.train_step(visual, motion, targets)
    probs = predict(trainer.model, visual, motion)

On the card each causal block's scan runs K3 forward (writing checkpoints)
and K4 backward at the preset's 548 tokens, and K5 forward and K6 backward
at 64 tokens or fewer. ``save`` / ``restore`` checkpoint the trainer's
whole state through its ``TrainerCore``.
"""

from __future__ import annotations

import inspect
from typing import Dict

import numpy as np
import torch

from ...utils.optim import make_optimizer
from ...utils.schedules import lambda_lr, make_schedule
from ...utils.trainer import (
    Checkpointing,
    TrainerCore,
    load_generator_state,
)
from .metrics import perframe_average_precision, topk_recall
from .model import LSTRMamba

IGNORE_INDEX = -100


def anticipation_loss(scores: torch.Tensor, targets: torch.Tensor,
                      ignore_index: int = IGNORE_INDEX) -> torch.Tensor:
    """Cross-entropy per position with an fp32 log-softmax, averaged over
    the targets that are not ``ignore_index``; targets (B, P) int."""
    valid = targets != ignore_index
    safe = torch.where(valid, targets, 0).long()
    logp = torch.log_softmax(scores.float(), dim=-1)
    ce = -torch.gather(logp, -1, safe[..., None])[..., 0]
    return torch.sum(ce * valid) / torch.clamp(torch.sum(valid), min=1)


def _on(device, *arrays):
    return [None if a is None else torch.as_tensor(a).to(device)
            for a in arrays]


def predict(model: LSTRMamba, visual, motion=None) -> torch.Tensor:
    """Softmax of the eval-mode scores, (B, work + anticipation,
    num_classes) fp32 on the model's device, for features (B, long + work,
    D) given as tensors or numpy arrays. The model's training flag is
    restored afterwards."""
    device = next(model.parameters()).device
    visual, motion = _on(device, visual, motion)
    was_training = model.training
    model.eval()
    try:
        with torch.inference_mode():
            scores = model(visual, motion)["score"]
            return torch.softmax(scores.float(), dim=-1)
    finally:
        model.train(was_training)


class AnticipationTrainer(Checkpointing):
    """Trains an ``LSTRMamba`` with the JAX trainer's recipe and defaults:
    AdamW with weight decay on every parameter (the JAX optimizer gets no
    mask) at ``make_schedule("cosine", lr, total_steps, warmup_steps)``.
    The trainer owns a generator on the model's device, seeded with
    ``seed``, for the classifier dropout's masks. ``use_mesh`` raises, as
    ``TrainerCore`` does."""

    def __init__(self, model: LSTRMamba, lr: float = 7e-5,
                 weight_decay: float = 5e-5, warmup_steps: int = 50,
                 total_steps: int = 5000, seed: int = 0,
                 use_mesh: bool = False):
        self.model = model
        self.device = next(model.parameters()).device
        self.core = TrainerCore(use_mesh=use_mesh, device=self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(
            seed)
        self.schedule = make_schedule("cosine", lr, total_steps,
                                      warmup_steps)
        self.optimizer = make_optimizer(model, "adamw", lr=lr,
                                        weight_decay=weight_decay)
        self.lr_scheduler = lambda_lr(self.optimizer, self.schedule)

    def train_step(self, visual, motion, targets) -> float:
        """One step on a batch: features (B, long + work, D) and int
        targets (B, work + anticipation), tensors or numpy arrays. Returns
        the loss before the update (reading it waits for the device)."""
        visual, motion, targets = _on(self.device, visual, motion, targets)
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        out = self.model(visual, motion, generator=self.generator)
        loss = anticipation_loss(out["score"], targets)
        loss.backward()
        self.optimizer.step()
        self.lr_scheduler.step()
        return float(loss.detach())

    def predict(self, visual, motion=None) -> torch.Tensor:
        return predict(self.model, visual, motion)

    def evaluate(self, visual, motion, targets) -> Dict[str, float]:
        """mean_AP (per-frame, background class 0 left out) and recall@5
        over the positions whose target is not ignored."""
        probs = self.predict(visual, motion).cpu().numpy()
        flat_p = probs.reshape(-1, probs.shape[-1])
        flat_t = np.asarray(targets).reshape(-1)
        valid = flat_t != IGNORE_INDEX
        res = perframe_average_precision(flat_p[valid], flat_t[valid])
        return {"mean_AP": res["mean_AP"],
                "recall@5": topk_recall(flat_p[valid], flat_t[valid], k=5)}

    def state_dict(self) -> dict:
        """Parameters, optimizer and schedule state, and the dropout
        generator's state."""
        return dict(model=self.model.state_dict(),
                    optimizer=self.optimizer.state_dict(),
                    lr_scheduler=self.lr_scheduler.state_dict(),
                    generator=self.generator.get_state())

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.lr_scheduler.load_state_dict(state["lr_scheduler"])
        load_generator_state(self.generator, state["generator"])


def build_anticipation_trainer(config: dict, device="cuda", seed: int = 0,
                               **overrides) -> AnticipationTrainer:
    """An ``LSTRMamba`` with random weights from ``seed`` and its trainer
    from a configuration of ``configs`` (``ANTICIPATION_EK100`` or
    ``ANTICIPATION_EK100_SHORT``: its ``model`` and ``opt`` entries).
    ``overrides`` change a trainer argument (``lr``, ``warmup_steps``, ...)
    or, otherwise, a model argument (``mamba_layers``, ``dropout_cls``,
    ...)."""
    known = set(inspect.signature(AnticipationTrainer).parameters)
    train_kw = dict(config["opt"], seed=seed)
    train_kw.update({k: v for k, v in overrides.items() if k in known})
    model_kw = dict(config["model"])
    model_kw.update({k: v for k, v in overrides.items() if k not in known})
    model = LSTRMamba(**model_kw, device=device,
                      generator=torch.Generator().manual_seed(seed))
    return AnticipationTrainer(model, **train_kw)
