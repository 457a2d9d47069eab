"""Training and evaluating UniVTG-Mamba for moment retrieval (the port's
``VtgTrainer``, counterpart of the JAX package's ``tasks/vtg/train.py``):
AdamW with weight decay on every parameter and clipping by the global
norm, the epoch-seeded sample order, and the decode of ranked spans in
seconds with the MR and HL metrics.

    trainer = build_vtg_trainer(configs.VTG_QVHIGHLIGHTS)
    losses = trainer.train_step(collate_vtg(samples, 32, 75))
    scores = trainer.evaluate(samples)

At the QVHighlights preset's 32 + 75 steps every DBM layer scans through
K3 on the card, once a direction (with checkpoints when a backward
follows), and K4 in the backward: 12 K3 and 12 K4 a step, 12 K3 a
forward. ``save`` / ``restore`` checkpoint the trainer's whole state
(``state_dict``).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ...data.sampler import sharded_epoch_order
from ...utils.optim import make_optimizer
from ...utils.trainer import (
    Checkpointing,
    TrainerCore,
    load_generator_state,
)
from .data import collate_vtg
from .losses import vtg_losses
from .metrics import compute_hl_ap, compute_hl_hit1, compute_mr_ap, compute_mr_r1
from .model import UniVTGMamba

INPUT_KEYS = ("src_txt", "src_txt_mask", "src_vid", "src_vid_mask")
TARGET_KEYS = (
    "timestamp", "timestamp_mask", "timestamp_window", "span_labels_nn",
    "saliency_scores", "saliency_pos_labels",
)


class UniVtgTrainer:
    """What the VTG trainers share: a ``UniVTGMamba`` built from
    ``model_kw``, AdamW at ``lr`` with weight decay on every parameter
    (the JAX optimizers get no mask) and, with ``grad_clip``, clipping by
    the global norm; a generator on the device seeded with ``seed`` for
    the dropouts and drop-paths; ``train_step`` on a batch dict through
    the subclass's ``loss``. Builds on ``device``, CUDA unless the caller
    passes "cpu"; ``use_mesh`` raises, as ``TrainerCore`` does. The
    state dict holds the generator's state and the epoch count, so that
    a resumed run continues as the uninterrupted one would."""

    def __init__(self, model_kw: dict, lr: float, weight_decay: float,
                 grad_clip, seed: int, device, use_mesh: bool = False):
        self.model = UniVTGMamba(**model_kw, device=device, seed=seed)
        self.device = next(self.model.parameters()).device
        self.core = TrainerCore(use_mesh=use_mesh, device=self.device)
        self.lr, self.weight_decay = lr, weight_decay
        self.grad_clip = grad_clip
        self.seed = seed
        self.init()

    def init(self) -> None:
        """A fresh optimizer state, epoch count and generator (the JAX
        ``init`` without its weights, which exist from the constructor
        on)."""
        self.optimizer = make_optimizer(
            self.model, "adamw", lr=self.lr, weight_decay=self.weight_decay,
            grad_clip=self.grad_clip)
        self.generator = torch.Generator(device=self.device).manual_seed(
            self.seed)
        self._epoch = -1

    def state_dict(self):
        return dict(params=self.model.state_dict(),
                    opt_state=self.optimizer.state_dict(),
                    generator=self.generator.get_state(),
                    epoch=self._epoch)

    def load_state_dict(self, state):
        self.model.load_state_dict(state["params"])
        self.optimizer.load_state_dict(state["opt_state"])
        load_generator_state(self.generator, state["generator"])
        self._epoch = state["epoch"]

    def _on(self, batch: Dict, keys) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(batch[k]).to(self.device) for k in keys}

    def forward(self, batch: Dict, train: bool = False, **kwargs) -> Dict:
        """The model on a batch dict with ``INPUT_KEYS`` (numpy arrays or
        tensors), in training mode (dropout from the generator) or eval
        mode; ``kwargs`` (``src_cls``, ``src_cls_mask``) go to the
        model."""
        x = self._on(batch, INPUT_KEYS)
        self.model.train(train)
        return self.model(*(x[k] for k in INPUT_KEYS),
                          generator=self.generator if train else None,
                          **kwargs)

    def loss(self, out: Dict, batch: Dict) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def apply_gradients(self, total: torch.Tensor) -> None:
        """Backward of ``total``, then the AdamW update of every parameter
        (a zero gradient where the loss does not reach, which still
        decays, as under optax)."""
        self.optimizer.zero_grad(set_to_none=True)
        total.backward()
        for p in self.model.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.optimizer.step()

    def train_step(self, batch: Dict, deterministic: bool = False
                   ) -> Dict[str, float]:
        """One step on a batch: the forward with dropout and drop-path
        (none with ``deterministic``), ``loss``, the backward and the
        update. Returns the losses before the update, read from the
        device once."""
        losses = self.loss(self.forward(batch, train=not deterministic),
                           batch)
        self.apply_gradients(losses["loss_total"])
        values = torch.stack([v.detach() for v in losses.values()]).cpu()
        return dict(zip(losses, values.tolist()))


class VtgTrainer(Checkpointing, UniVtgTrainer):
    """The JAX ``VtgTrainer``: moment retrieval with ``vtg_losses`` (its
    default weights) on ``collate_vtg`` batches padded to ``max_q_l`` /
    ``max_v_l``; the model's drop-path is its 0.1; AdamW clipped at
    ``grad_clip``."""

    def __init__(self, txt_dim: int, vid_dim: int, embed_dim: int = 256,
                 depth: int = 4, mamba_type: str = "vim", lr: float = 1e-4,
                 weight_decay: float = 1e-4, grad_clip: float = 0.1,
                 max_q_l: int = 32, max_v_l: int = 75,
                 input_dropout: float = 0.5, seed: int = 0,
                 use_mesh: bool = False, device="cuda"):
        super().__init__(dict(txt_dim=txt_dim, vid_dim=vid_dim,
                              embed_dim=embed_dim, depth=depth,
                              mamba_type=mamba_type,
                              input_dropout=input_dropout),
                         lr, weight_decay, grad_clip, seed, device, use_mesh)
        self.max_q_l, self.max_v_l = max_q_l, max_v_l

    def loss(self, out: Dict, batch: Dict) -> Dict[str, torch.Tensor]:
        return vtg_losses(out, self._on(batch, TARGET_KEYS))

    def train_epoch(self, samples: List[dict], batch_size: int = 4
                    ) -> Dict[str, float]:
        """One pass over ``samples`` in the epoch's seeded order, in
        batches of ``batch_size`` (a last batch of one sample is
        skipped). Returns the mean of each loss."""
        self._epoch += 1
        order = sharded_epoch_order(len(samples), self._epoch)
        agg: Dict[str, float] = {}
        nb = 0
        for i in range(0, len(samples), batch_size):
            chunk = [samples[j] for j in order[i:i + batch_size]]
            if len(chunk) < 2:
                continue
            losses = self.train_step(collate_vtg(chunk, self.max_q_l,
                                                 self.max_v_l))
            for k, v in losses.items():
                agg[k] = agg.get(k, 0.0) + v
            nb += 1
        return {k: v / max(nb, 1) for k, v in agg.items()}

    def predict(self, samples: List[dict], topk: int = 10) -> List[dict]:
        """Ranked spans in seconds, 8 samples a forward: timestamp +
        pred_spans, times the duration, clipped to [0, duration], the
        ``topk`` clips of highest foreground probability, each [start,
        end, probability]; and the clips' saliency scores."""
        submission = []
        for i in range(0, len(samples), 8):
            chunk = samples[i:i + 8]
            batch = collate_vtg(chunk, self.max_q_l, self.max_v_l)
            with torch.inference_mode():
                out = self.forward(batch)
                host = torch.cat([out["pred_spans"], out["pred_logits"],
                                  out["saliency_scores"][..., None]],
                                 dim=-1).float().cpu().numpy()
            spans = batch["timestamp"] + host[..., :2]
            prob, sal = host[..., 2], host[..., 3]
            for j, s in enumerate(chunk):
                dur = s["duration"]
                lv = min(len(s["vid_feat"]), self.max_v_l)
                sp = np.clip(spans[j, :lv] * dur, 0, dur)
                pr = prob[j, :lv]
                order = np.argsort(-pr)[:topk]
                windows = [[float(sp[k, 0]), float(sp[k, 1]), float(pr[k])]
                           for k in order]
                submission.append(dict(
                    qid=s["qid"], pred_relevant_windows=windows,
                    pred_saliency_scores=sal[j, :lv].tolist()))
        return submission

    def evaluate(self, samples: List[dict]) -> Dict[str, float]:
        """mAP_avg, mIoU@1, R1@0.5 and R1@0.7 of ``predict``'s windows,
        and HL_hit1 and HL_mAP of its saliency against each sample's
        in-window indicator."""
        submission = self.predict(samples)
        gt = [dict(qid=s["qid"], relevant_windows=s["relevant_windows"])
              for s in samples]
        mr_ap = compute_mr_ap(submission, gt)
        r1, miou = compute_mr_r1(submission, gt)
        out = {"mAP_avg": mr_ap["average"], "mIoU@1": miou}
        for t in ("0.5", "0.7"):
            if t in r1:
                out[f"R1@{t}"] = r1[t]
        qid2preds = {s["qid"]: s for s in submission}
        qid2gt = {}
        for s in samples:
            lv = min(len(s["vid_feat"]), self.max_v_l)
            qid2gt[s["qid"]] = s["targets"]["timestamp_window"][:lv][:, None]
        out["HL_hit1"] = compute_hl_hit1(qid2preds, qid2gt)
        out["HL_mAP"] = compute_hl_ap(qid2preds, qid2gt)
        return out


def vtg_trainer_kwargs(config: dict) -> dict:
    """A moment-retrieval preset of ``configs`` read as the JAX CLI reads
    it: the feature widths, the model's width, depth and mixer, the
    learning rate, and the padding lengths (``dataset`` first, then
    ``model``, then 32 and 75). Weight decay, clipping, input dropout and
    drop-path are the trainer's and the model's defaults, equal to every
    preset's."""
    m, d = config["model"], config["dataset"]
    return dict(
        txt_dim=d["t_feat_dim"], vid_dim=d["v_feat_dim"],
        embed_dim=m["embed_dim"], depth=m["depth"],
        mamba_type=m["mamba_type"], lr=config["opt"]["learning_rate"],
        max_q_l=d.get("max_q_l", m.get("max_q_l", 32)),
        max_v_l=d.get("max_v_l", m.get("max_v_l", 75)))


def build_vtg_trainer(config: dict, device="cuda", seed: int = 0,
                      **overrides) -> VtgTrainer:
    """A ``VtgTrainer`` from a moment-retrieval configuration of
    ``configs`` (``VTG_QVHIGHLIGHTS``, ``VTG_CHARADES``, ``VTG_TACOS`` or
    ``VTG_EGO4D``; ``vtg_trainer_kwargs``). Random weights from ``seed``;
    ``overrides`` change any ``VtgTrainer`` argument. The batch size is
    ``config["loader"]["batch_size"]``, the caller's."""
    kw = dict(vtg_trainer_kwargs(config), seed=seed, device=device)
    kw.update(overrides)
    return VtgTrainer(**kw)
