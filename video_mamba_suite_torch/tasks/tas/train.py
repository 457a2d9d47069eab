"""Training and evaluating ASFormer-Mamba (the port's ``TasTrainer``,
counterpart of the JAX package's ``tasks/tas/train.py``): per stage the
cross-entropy over the valid frames plus 0.15 × the truncated smoothing
loss, Adam with L2 weight decay (``optax.chain(add_decayed_weights, adam)``
is ``torch.optim.Adam(weight_decay=...)``), the rate halved after more
than 3 epochs without a lower summed loss, and the frame metrics.

    trainer = build_tas_trainer(configs.TAS_GTEA)
    loss = trainer.train_step(feats, targets, mask)
    scores = trainer.evaluate([(features, labels), ...])

At the presets' widths every encoder layer scans its videos of more than
64 steps through K3 on the card (twice, one per direction; with
checkpoints when a backward follows) and K4 in the backward: 20 K3 and 20
K4 a step. ``save`` / ``restore`` checkpoint the trainer's whole state
(``state_dict``).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...utils.optim import make_optimizer
from ...utils.schedules import ReduceLROnPlateau
from ...utils.trainer import (
    Checkpointing,
    TrainerCore,
    load_generator_state,
)
from .data import IGNORE_INDEX, TasBatchGenerator, collate
from .metrics import evaluate_segmentation
from .model import MaTransformer


def tas_loss(stage_logits: torch.Tensor, targets: torch.Tensor,
             mask: torch.Tensor, smooth_weight: float = 0.15,
             clamp_max: float = 16.0) -> torch.Tensor:
    """The sum over stages of the cross-entropy, averaged over the valid
    frames (target not ``IGNORE_INDEX`` and mask on), plus
    ``smooth_weight`` × the mean over (B, L − 1, C) of the squared change
    of the log-probabilities from the previous frame (that frame
    detached), clamped at ``clamp_max`` and masked by ``mask[:, 1:]``.

    stage_logits (S, B, L, C); targets (B, L); mask (B, L). fp32."""
    valid = (targets != IGNORE_INDEX) & (mask > 0)
    safe_t = torch.where(valid, targets, 0)
    count = valid.sum().clamp_min(1)
    total = stage_logits.new_zeros((), dtype=torch.float32)
    for logits in stage_logits:
        logp = F.log_softmax(logits.float(), dim=-1)
        ce = -logp.gather(-1, safe_t[..., None])[..., 0]
        ce = (ce * valid).sum() / count
        diff = logp[:, 1:] - logp[:, :-1].detach()
        sm = (diff.square().clamp(0, clamp_max)
              * mask[:, 1:, None]).mean()
        total = total + ce + smooth_weight * sm
    return total


class TasTrainer(Checkpointing):
    """Trains a ``MaTransformer`` (its drop-path the model's 0.3) with the
    JAX trainer's recipe and defaults: Adam at ``lr`` with L2 weight decay ``weight_decay`` on every
    parameter, the rate scaled by ``ReduceLROnPlateau(0.5, patience 3)``
    on each epoch's summed loss. The dropouts and drop-paths draw from a
    generator on the device seeded with ``seed``. Builds on ``device``,
    CUDA unless the caller passes "cpu"; ``use_mesh`` raises, as
    ``TrainerCore`` does."""

    def __init__(self, num_classes: int, input_dim: int,
                 num_layers: int = 10, num_f_maps: int = 64,
                 num_decoders: int = 3, channel_masking_rate: float = 0.3,
                 lr: float = 5e-4, weight_decay: float = 1e-5,
                 mixer: str = "vim", seed: int = 0, use_mesh: bool = False,
                 device="cuda"):
        self.model = MaTransformer(
            num_decoders=num_decoders, num_layers=num_layers,
            num_f_maps=num_f_maps, input_dim=input_dim,
            num_classes=num_classes,
            channel_masking_rate=channel_masking_rate, mixer=mixer,
            device=device, seed=seed)
        self.device = next(self.model.parameters()).device
        self.core = TrainerCore(use_mesh=use_mesh, device=self.device)
        self.num_classes = num_classes
        self.lr = lr
        self.weight_decay = weight_decay
        self.seed = seed
        self.init()

    def init(self) -> None:
        """A fresh optimizer state, plateau count and generator (the JAX
        ``init`` without its weights, which exist from the constructor
        on)."""
        self.optimizer = make_optimizer(self.model, "adam", lr=self.lr,
                                        weight_decay=self.weight_decay)
        self.plateau = ReduceLROnPlateau(factor=0.5, patience=3)
        self._lr_scale = 1.0
        self.generator = torch.Generator(device=self.device).manual_seed(
            self.seed)

    def state_dict(self):
        return dict(params=self.model.state_dict(),
                    opt_state=self.optimizer.state_dict(),
                    plateau=vars(self.plateau).copy(),
                    lr_scale=self._lr_scale,
                    generator=self.generator.get_state())

    def load_state_dict(self, state):
        self.model.load_state_dict(state["params"])
        self.optimizer.load_state_dict(state["opt_state"])
        vars(self.plateau).update(state["plateau"])
        self._lr_scale = state["lr_scale"]
        load_generator_state(self.generator, state["generator"])

    def set_lr_scale(self, scale: float) -> None:
        """The optimizer's rate becomes ``lr`` × ``scale``."""
        if scale != self._lr_scale:
            self._lr_scale = scale
            for group in self.optimizer.param_groups:
                group["lr"] = self.lr * scale

    def _on(self, *arrays):
        return [torch.as_tensor(a).to(self.device) for a in arrays]

    def train_step(self, feats, targets, mask,
                   deterministic: bool = False) -> float:
        """One step on a ``collate`` batch (numpy arrays or tensors): the
        forward with dropout (none with ``deterministic``), ``tas_loss``,
        the backward and the Adam update of every parameter. Returns the
        loss before the update (reading it waits for the device)."""
        feats, targets, mask = self._on(feats, targets, mask)
        self.model.train(not deterministic)
        self.optimizer.zero_grad(set_to_none=True)
        logits = self.model(feats, mask, self.generator)
        loss = tas_loss(logits, targets, mask)
        loss.backward()
        for p in self.model.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.optimizer.step()
        return float(loss.detach())

    def predict(self, feats, mask) -> Tuple[torch.Tensor, torch.Tensor]:
        """The last stage's frame labels (B, L) and class probabilities
        (B, L, C) in eval mode."""
        feats, mask = self._on(feats, mask)
        self.model.eval()
        with torch.inference_mode():
            logits = self.model(feats, mask)[-1]
        return logits.argmax(dim=-1), torch.softmax(logits, dim=-1)

    def train_epoch(self, batch_gen: TasBatchGenerator, batch_size: int,
                    if_warp: bool = False) -> Dict[str, float]:
        """One pass over ``batch_gen`` (a step, then a prediction of the
        batch for the frame accuracy), its ``reset``, and the plateau
        step on the epoch's summed loss. Returns the mean loss and the
        frame accuracy."""
        epoch_loss, nb, correct, total = 0.0, 0, 0, 0
        while batch_gen.has_next():
            feats, targets, mask, _ = batch_gen.next_batch(batch_size,
                                                           if_warp)
            epoch_loss += self.train_step(feats, targets, mask)
            nb += 1
            preds, _ = self.predict(feats, mask)
            valid = (targets != IGNORE_INDEX) & (mask > 0)
            correct += int(((preds.cpu().numpy() == targets) & valid).sum())
            total += int(valid.sum())
        batch_gen.reset()
        self.set_lr_scale(self.plateau.step(epoch_loss))
        return {"loss": epoch_loss / max(nb, 1),
                "acc": correct / max(total, 1)}

    def evaluate(self, items: List[Tuple[np.ndarray, np.ndarray]]
                 ) -> Dict[str, float]:
        """``evaluate_segmentation`` of each video's predicted labels:
        items are (features (C, L), labels (L,)), one video a forward."""
        preds, gts = [], []
        for f, l in items:
            feats, _, mask = collate([(f, l)])
            p, _ = self.predict(feats, mask)
            preds.append(p[0, :len(l)].cpu().numpy())
            gts.append(l)
        return evaluate_segmentation(preds, gts)


def build_tas_trainer(config: dict, device="cuda", seed: int = 0,
                      **overrides) -> TasTrainer:
    """A ``TasTrainer`` from a configuration of ``configs`` (``TAS_GTEA``,
    ``TAS_50SALADS`` or ``TAS_BREAKFAST``): its classes, model widths and
    recipe (the JAX CLI's reading of a preset). Random weights from ``seed``; ``overrides`` change any
    ``TasTrainer`` argument."""
    m, o = config["model"], config["opt"]
    kw = dict(num_classes=config["dataset"]["num_classes"],
              input_dim=m["input_dim"], num_layers=m["num_layers"],
              num_f_maps=m["num_f_maps"], num_decoders=m["num_decoders"],
              channel_masking_rate=m["channel_masking_rate"],
              mixer=m["mixer"],
              lr=o["learning_rate"], weight_decay=o["weight_decay"],
              seed=seed, device=device)
    kw.update(overrides)
    return TasTrainer(**kw)
