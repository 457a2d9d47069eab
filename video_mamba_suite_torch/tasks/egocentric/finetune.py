"""EK100 fine-tuning of the CLIP dual encoder and of its video tower (the
port's counterparts of the JAX package's ``tasks/egocentric/finetune.py``):

  MirFinetuner   multi-instance retrieval: the max-margin ranking loss on
                 the batch's text-by-video similarities, AdamW (b2 0.98)
                 under a warmup-cosine schedule with clip 1.0; evaluation
                 encodes the set and scores mAP and nDCG against the
                 relevancy matrix, as upstream's ``validate_mir`` does;
  VideoClassifier  the video tower without its projection, dropout and a
                 linear head ``fc_cls``;
  ClsFinetuner   action classification: mixup / cutmix with label
                 smoothing and the soft-target cross entropy, AdamW under
                 a warmup-cosine schedule with clip 1.0; top-1 / top-5 over
                 multi-crop probabilities, with verb and noun marginals.

Both trainers apply every parameter's update each step, as optax does: a
parameter the loss does not reach (the temperature in the ranking loss)
takes a zero gradient and so its weight decay. Weight decay falls on every
parameter: the JAX trainers build their optimizer without the no-decay
mask. ``save`` / ``restore`` checkpoint a trainer's whole state: its
weights, optimizer, schedule and generators.

``build_clip_mir`` and ``build_ek100_cls`` are the entry points: random
weights from a seed at the presets' widths, on the card.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ...configs import CLIP_TIMEMAMBA_B_EK100_MIR, EGO_EK100_CLS
from ...models.clip import CLIP
from ...models.common import Dense, dropout
from ...models.vivim import ViViM
from ...utils.optim import make_optimizer
from ...utils.schedules import lambda_lr, make_schedule
from ...utils.trainer import (
    Checkpointing,
    TrainerCore,
    load_generator_state,
)
from ..recognition.augment import (
    MixDraw,
    apply_mixup_cutmix,
    mixup_cutmix,
    one_hot_smooth,
)
from ..recognition.train import soft_target_cross_entropy
from .losses import max_margin_ranking_loss
from .metrics import get_mAP, get_nDCG, marginalize


def _device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


class _AdamWTrainer(Checkpointing):
    """The optax chain clip_by_global_norm → adamw(warmup-cosine) of the
    JAX egocentric trainers over ``self.model``'s parameters, and their
    checkpoints: the state dict holds the generators named in
    ``GENERATORS`` (each trainer's dropout and mixup draws), so that a
    resumed run continues as the uninterrupted one would. ``use_mesh``
    raises, as ``TrainerCore`` does."""

    GENERATORS = ("generator",)

    def _build_optimizer(self, lr: float, weight_decay: float,
                         warmup_steps: int, total_steps: int,
                         grad_clip: Optional[float], b2: float) -> None:
        self.schedule = make_schedule("cosine", lr, total_steps,
                                      warmup_steps)
        self._opt_args = (lr, weight_decay, warmup_steps, total_steps,
                          grad_clip, b2)
        self.optimizer = make_optimizer(self.model, "adamw", lr=lr,
                                        weight_decay=weight_decay, b2=b2,
                                        grad_clip=grad_clip)
        self.lr_scheduler = lambda_lr(self.optimizer, self.schedule)

    def _reset_optimizer(self) -> None:
        """A fresh optimizer state, the schedule from its start."""
        self._build_optimizer(*self._opt_args)

    def _update(self, loss: torch.Tensor) -> float:
        """Backward of ``loss``, then one update of every parameter; the
        loss as a float (reading it waits for the device)."""
        loss.backward()
        for p in self.model.parameters():
            if p.requires_grad and p.grad is None:
                p.grad = torch.zeros_like(p)
        self.optimizer.step()
        self.lr_scheduler.step()
        return float(loss.detach())

    def state_dict(self):
        return dict(params=self.model.state_dict(),
                    opt_state=self.optimizer.state_dict(),
                    lr_scheduler=self.lr_scheduler.state_dict(),
                    **{name: getattr(self, name).get_state()
                       for name in self.GENERATORS})

    def load_state_dict(self, state):
        self.model.load_state_dict(state["params"])
        self.optimizer.load_state_dict(state["opt_state"])
        self.lr_scheduler.load_state_dict(state["lr_scheduler"])
        for name in self.GENERATORS:
            load_generator_state(getattr(self, name), state[name])


class MirFinetuner(_AdamWTrainer):
    """EK100 MIR engine around a ``CLIP``: ``train_step`` fine-tunes it,
    ``encode_dataset`` embeds the evaluation set in batches, ``evaluate``
    scores it. Dropout and drop-path masks come from a generator on the
    model's device seeded with ``seed``."""

    def __init__(self, model: CLIP, lr: float = 1e-5,
                 weight_decay: float = 0.01, warmup_steps: int = 100,
                 total_steps: int = 10000, margin: float = 0.2,
                 grad_clip: float = 1.0, use_mesh: bool = False,
                 seed: int = 0):
        self.model = model
        self.margin = margin
        self.generator = torch.Generator(
            device=_device(model)).manual_seed(seed)
        self._build_optimizer(lr, weight_decay, warmup_steps, total_steps,
                              grad_clip, 0.98)
        self.core = TrainerCore(use_mesh=use_mesh, device=_device(model))

    def init(self, params: Optional[dict] = None) -> None:
        """Adopt a pretrained CLIP state_dict ``params`` (the resume path),
        if given, and start the optimizer afresh."""
        if params is not None:
            self.model.load_state_dict(params)
        self._reset_optimizer()

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
        img, txt, _ = self.model(videos, texts, generator=self.generator)
        # rows are captions, columns clips (upstream's sim_matrix(text, video))
        sim = txt @ img.T
        return self._update(max_margin_ranking_loss(sim, self.margin))

    def encode_dataset(self, videos, texts, batch_size: int = 8
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """Normalised embeddings (n, embed_dim) of the clips (n, T, H, W, 3)
        and of the token ids (n, L), as numpy fp32, encoded in batches of
        ``batch_size`` (clip i with caption i) under inference mode."""
        device = _device(self.model)
        was_training = self.model.training
        self.model.eval()
        vids, txts = [], []
        with torch.inference_mode():
            for i in range(0, len(videos), batch_size):
                v = torch.as_tensor(videos[i:i + batch_size]).to(device)
                t = torch.as_tensor(texts[i:i + batch_size]).to(
                    device=device, dtype=torch.long)
                img, txt, _ = self.model(v.float(), t)
                vids.append(img.cpu().numpy())
                txts.append(txt.cpu().numpy())
        self.model.train(was_training)
        return np.concatenate(vids, 0), np.concatenate(txts, 0)

    def evaluate(self, videos, texts, rel_matrix: np.ndarray,
                 batch_size: int = 8,
                 text_index: Optional[np.ndarray] = None) -> Dict[str, float]:
        """mAP and nDCG of the evaluation set, video to text and text to
        video, against ``rel_matrix`` (n_videos, n_texts). ``text_index``
        reindexes the text columns (upstream's selection of unique
        captions)."""
        vid_emb, txt_emb = self.encode_dataset(videos, texts, batch_size)
        sim = (vid_emb @ txt_emb.T + 1) / 2
        if text_index is not None:
            sim = sim[:, text_index]
        v_map, t_map, avg_map = get_mAP(sim, rel_matrix)
        v_ndcg, t_ndcg, avg_ndcg = get_nDCG(sim, rel_matrix)
        return dict(vis_map=v_map, txt_map=t_map, avg_map=avg_map,
                    vis_ndcg=v_ndcg, txt_ndcg=t_ndcg, avg_ndcg=avg_ndcg)


def _clip(config, device, seed: int, attn_flash,
          vision_dtype: Optional[torch.dtype]) -> CLIP:
    """The ``CLIP`` of ``config["model"]`` with the video tower's spatial
    attention kernel ``attn_flash`` and compute dtype ``vision_dtype``."""
    m = config["model"]
    vision_cfg = dict(m["vision_cfg"])
    if vision_dtype is not None:
        vision_cfg["dtype"] = vision_dtype
    if attn_flash is not None:
        vision_cfg["attn_flash"] = attn_flash
    return CLIP(embed_dim=m["embed_dim"], vision_tower=m["vision_tower"],
                vision_cfg=vision_cfg, text_cfg=dict(m["text_cfg"]),
                device=device, seed=seed)


def build_clip_mir(config=CLIP_TIMEMAMBA_B_EK100_MIR, device="cuda",
                   seed: int = 0, attn_flash=None,
                   vision_dtype: Optional[torch.dtype] = None,
                   **trainer_kw) -> MirFinetuner:
    """A ``MirFinetuner`` holding the ``CLIP`` of ``config`` (default
    CLIP-TimeMamba-B at the EK100 MIR preset's widths) with random weights
    from ``seed``, on ``device`` ("cuda" unless the caller asks for "cpu"),
    and the preset's recipe (``config["opt"]``: lr, weight decay).
    ``attn_flash`` is the video tower's spatial attention kernel (None: the
    einsum path; "row": K10) and ``vision_dtype`` its compute dtype (None:
    fp32); the text tower runs in fp32. ``trainer_kw`` overrides the
    trainer's arguments (``warmup_steps``, ``total_steps``, ...)."""
    model = _clip(config, device, seed, attn_flash, vision_dtype)
    kw = dict(config["opt"], seed=seed)
    kw.update(trainer_kw)
    return MirFinetuner(model, **kw)


class VideoClassifier(nn.Module):
    """A video tower that emits backbone-wide features (TimeMamba or ViViM
    with ``output_dim`` None and no head), dropout at ``dropout``, and the
    linear head ``fc_cls`` drawn from N(0, 0.01²) with a zero bias, on the
    tower's device. ``forward`` takes a generator for the masks of the
    tower and of the dropout in training mode."""

    def __init__(self, vision_tower: nn.Module, num_classes: int,
                 dropout: float = 0.5, seed: int = 0):
        super().__init__()
        self.vision_tower = vision_tower
        self.dropout = dropout
        g = torch.Generator().manual_seed(seed)
        self.fc_cls = Dense(vision_tower.embed_dim, num_classes, generator=g)
        with torch.no_grad():
            self.fc_cls.weight.normal_(0.0, 0.01, generator=g)
        self.fc_cls.to(_device(vision_tower))

    def forward(self, videos: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        feats = self.vision_tower(videos, generator)
        feats = dropout(feats, self.dropout, self.training, generator)
        return self.fc_cls(feats)


class ClsFinetuner(_AdamWTrainer):
    """EK100 action classification on a video tower: ``train_step`` on a
    batch of clips and action labels, ``predict`` the class probabilities,
    ``evaluate`` top-1 / top-5 and the verb / noun marginals.

    The trainer owns two generators seeded with ``seed``: one on the CPU
    for the mixup / cutmix draws and one on the model's device for the
    dropout and drop-path masks. Mixup needs both alphas positive (the
    JAX draw gives NaN with one at 0), and its box centre shares a row and
    a column draw, as the JAX one does."""

    GENERATORS = ("generator", "drop_generator")

    def __init__(self, vision_tower: nn.Module, num_classes: int,
                 lr: float = 1e-4, weight_decay: float = 0.05,
                 warmup_steps: int = 100, total_steps: int = 10000,
                 dropout: float = 0.5, smoothing: float = 0.1,
                 mixup_alpha: float = 0.0, cutmix_alpha: float = 0.0,
                 grad_clip: float = 1.0, use_mesh: bool = False,
                 seed: int = 0):
        self.model = VideoClassifier(vision_tower, num_classes, dropout,
                                     seed=seed)
        self.num_classes = num_classes
        self.smoothing = smoothing
        self.mixup_alpha = mixup_alpha
        self.cutmix_alpha = cutmix_alpha
        self.generator = torch.Generator().manual_seed(seed)
        self.drop_generator = torch.Generator(
            device=_device(vision_tower)).manual_seed(seed)
        self._build_optimizer(lr, weight_decay, warmup_steps, total_steps,
                              grad_clip, 0.999)
        self.core = TrainerCore(use_mesh=use_mesh,
                                device=_device(vision_tower))

    def init(self, pretrained_visual: Optional[dict] = None) -> None:
        """Graft a pretrained tower's state_dict into the classifier (its
        projection, if it has one, is dropped), if given, and start the
        optimizer afresh."""
        if pretrained_visual is not None:
            tower = {k: v for k, v in pretrained_visual.items()
                     if k != "image_projection"}
            self.model.vision_tower.load_state_dict(tower)
        self._reset_optimizer()

    def train_step(self, videos, labels,
                   draw: Optional[MixDraw] = None) -> float:
        """One step on clips (B, T, H, W, 3) and int action labels (B,),
        tensors or numpy arrays. With mixup or cutmix on, ``draw`` gives
        the random numbers of the mix (else they come from the trainer's
        generator). Returns the loss before the update."""
        device = _device(self.model)
        videos = torch.as_tensor(videos).to(device=device,
                                            dtype=torch.float32)
        labels = torch.as_tensor(labels).to(device)
        if self.mixup_alpha > 0 or self.cutmix_alpha > 0:
            if draw is None:
                videos, targets = mixup_cutmix(
                    self.generator, videos, labels, self.num_classes,
                    self.mixup_alpha, self.cutmix_alpha,
                    smoothing=self.smoothing)
            else:
                videos, targets = apply_mixup_cutmix(
                    videos, labels, self.num_classes, draw,
                    smoothing=self.smoothing)
        else:
            targets = one_hot_smooth(labels, self.num_classes,
                                     self.smoothing)
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        logits = self.model(videos, generator=self.drop_generator)
        return self._update(soft_target_cross_entropy(logits, targets))

    def predict(self, videos, batch_size: int = 8) -> np.ndarray:
        """Class probabilities (N, num_classes), fp32 numpy, of clips
        (N, T, H, W, 3) in batches, under inference mode."""
        device = _device(self.model)
        was_training = self.model.training
        self.model.eval()
        probs = []
        with torch.inference_mode():
            for i in range(0, len(videos), batch_size):
                v = torch.as_tensor(videos[i:i + batch_size]).to(
                    device=device, dtype=torch.float32)
                probs.append(torch.softmax(self.model(v).float(), dim=-1)
                             .cpu().numpy())
        self.model.train(was_training)
        return np.concatenate(probs, 0)

    def evaluate(self, videos, labels: np.ndarray, batch_size: int = 8,
                 action_to_verb: Optional[Sequence[np.ndarray]] = None,
                 action_to_noun: Optional[Sequence[np.ndarray]] = None
                 ) -> Dict[str, float]:
        """Action top-1 / top-5 in %, and verb / noun top-1 / top-5 where
        ``action_to_verb`` / ``action_to_noun`` list, for each verb or
        noun, the actions that hold it. ``videos`` (N, crops, T, H, W, 3)
        are scored on every crop and the crops' probabilities averaged."""
        multi = videos.ndim == 6
        flat = videos.reshape((-1,) + tuple(videos.shape[2:])) if multi \
            else videos
        probs = self.predict(flat, batch_size)
        if multi:
            probs = probs.reshape(videos.shape[0], videos.shape[1],
                                  -1).mean(1)
        labels = np.asarray(labels)
        order = np.argsort(-probs, axis=1)
        out = {"action_top1": float(np.mean(order[:, 0] == labels) * 100),
               "action_top5": float(np.mean(np.any(
                   order[:, :5] == labels[:, None], 1)) * 100)}
        for name, idx_map in (("verb", action_to_verb),
                              ("noun", action_to_noun)):
            if idx_map is None:
                continue
            m_probs = marginalize(probs, idx_map)
            groups = np.array([
                next(g for g, acts in enumerate(idx_map)
                     if int(label) in set(np.asarray(acts).tolist()))
                for label in labels])
            m_order = np.argsort(-m_probs, axis=1)
            out[f"{name}_top1"] = float(np.mean(m_order[:, 0] == groups)
                                        * 100)
            out[f"{name}_top5"] = float(np.mean(np.any(
                m_order[:, :5] == groups[:, None], 1)) * 100)
        return out


def build_ek100_cls(config=EGO_EK100_CLS, device="cuda", seed: int = 0,
                    **trainer_kw) -> ClsFinetuner:
    """A ``ClsFinetuner`` at ``config``'s widths and recipe (default the
    EK100 preset: ViViM-T, 16 frames at 224², 3806 actions, AdamW lr 1e-4,
    weight decay 0.05, smoothing 0.1, mixup 0.8, cutmix 1.0), random
    weights from ``seed``, on ``device`` ("cuda" unless the caller asks for
    "cpu"). ``trainer_kw`` overrides the trainer's arguments."""
    tower = ViViM(**config["model"], num_classes=0, output_dim=None,
                  device=device, seed=seed)
    kw = dict(config["opt"], **config["aug"])
    kw.update(trainer_kw)
    return ClsFinetuner(tower, config["num_classes"], seed=seed, **kw)
