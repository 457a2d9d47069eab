"""Training and evaluating ActionMamba (the port's ``TalTrainer``,
counterpart of the JAX package's ``tasks/tal/train.py``): AdamW under a
warmup-cosine schedule with clipping by the global norm, an EMA of the
weights, the loss normaliser's moving average, and the eval's decode,
soft-NMS and mAP.

    trainer = build_tal_trainer(configs.TAL_THUMOS)
    losses = trainer.train_step(feats, mask, segs, labels, valid)
    mAP, avg = trainer.evaluate(videos)

At THUMOS-14's 2304 steps every mixer of the pyramid scans through K3
(writing checkpoints) and K4 on the card; ActivityNet's levels of 48, 24
and 12 steps through K1 and K2. ``save`` / ``restore`` checkpoint the
trainer's whole state (``state_dict``).
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional

import numpy as np
import torch

from ...data.sampler import sharded_epoch_order
from ...utils.ema import ModelEma
from ...utils.optim import make_optimizer
from ...utils.schedules import lambda_lr, make_schedule
from ...utils.trainer import (
    Checkpointing,
    TrainerCore,
    load_generator_state,
)
from .data import collate_tal
from .metrics import ANETdetection
from .model import (
    ActionMambaDetector,
    decode_single_video,
    label_points,
    tal_losses,
)
from .nms import batched_nms

LOSS_NAMES = ("cls_loss", "reg_loss", "final_loss")


def fuse_external_scores(segs, scores, ext_scores, topk_per_prop: int = 2,
                         max_out: int = 200):
    """Class-agnostic proposals labelled by a video-level classifier (the
    THUMOS ``ext_score_file`` mode): each proposal becomes one detection
    for each of the classifier's ``topk_per_prop`` best classes, scored
    sqrt(proposal score · class score); the ``max_out`` best are kept."""
    ext = np.asarray(ext_scores, np.float64)
    top_cls = np.argsort(-ext)[:topk_per_prop]
    out_segs, out_scores, out_labels = [], [], []
    for seg, sc in zip(np.asarray(segs), np.asarray(scores)):
        for c in top_cls:
            out_segs.append(seg)
            out_scores.append(float(np.sqrt(max(sc, 0) * ext[c])))
            out_labels.append(int(c))
    order = np.argsort(-np.asarray(out_scores))[:max_out]
    return (np.asarray(out_segs)[order], np.asarray(out_scores)[order],
            np.asarray(out_labels)[order])


class TalTrainer(Checkpointing):
    """Trains an ``ActionMambaDetector`` with the JAX trainer's recipe and
    defaults: AdamW with weight decay on every parameter (the JAX
    optimizer gets no mask) at ``make_schedule("cosine", lr, total_steps,
    warmup_steps)``, the gradients clipped to a global norm of
    ``grad_clip``, an EMA of the weights after each step, and the loss
    normaliser's moving average kept on the device from
    ``init_loss_norm``. ``drop_path_rate`` is the detector's (the
    preset's 0.1); the trainer owns a generator on the device, seeded with
    ``seed``, for its masks. Builds on ``device``, CUDA unless the caller
    passes "cpu"; ``use_mesh`` raises, as ``TrainerCore`` does."""

    def __init__(self, input_dim: int, num_classes: int,
                 max_seq_len: int = 2304, embd_dim: int = 512,
                 regression_range=None, backbone_arch=(2, 2, 5),
                 lr: float = 1e-4, weight_decay: float = 0.05,
                 warmup_steps: int = 100, total_steps: int = 10000,
                 grad_clip: float = 1.0, ema_decay: float = 0.999,
                 label_smoothing: float = 0.0, init_loss_norm: float = 100.0,
                 center_sample_radius: float = 1.5, mixer: str = "dbm",
                 max_num_gt: int = 32, seed: int = 0,
                 test_cfg: Optional[dict] = None,
                 drop_path_rate: float = 0.1, use_mesh: bool = False,
                 device="cuda"):
        kwargs = dict(max_seq_len=max_seq_len, embd_dim=embd_dim,
                      fpn_dim=embd_dim, head_dim=embd_dim,
                      backbone_arch=tuple(backbone_arch), mixer=mixer,
                      drop_path_rate=drop_path_rate)
        if regression_range is not None:
            kwargs["regression_range"] = tuple(map(tuple, regression_range))
        self.model = ActionMambaDetector(input_dim, num_classes, **kwargs,
                                         device=device, seed=seed)
        self.device = next(self.model.parameters()).device
        self.core = TrainerCore(use_mesh=use_mesh, device=self.device)
        self.num_classes = num_classes
        self.max_seq_len = max_seq_len
        self.max_num_gt = max_num_gt
        self.ema_decay = ema_decay
        self.label_smoothing = label_smoothing
        self.center_sample_radius = center_sample_radius
        self.point_gen = self.model.make_points()
        self.test_cfg = dict(
            pre_nms_thresh=0.001, pre_nms_topk=2000, iou_threshold=0.1,
            min_score=0.001, max_seg_num=200, nms_method="soft",
            duration_thresh=0.05, multiclass_nms=True, nms_sigma=0.5,
            voting_thresh=0.7)
        if test_cfg:
            self.test_cfg.update(test_cfg)
        self.generator = torch.Generator(device=self.device).manual_seed(
            seed)
        self.schedule = make_schedule("cosine", lr, total_steps,
                                      warmup_steps)
        self.optimizer = make_optimizer(self.model, "adamw", lr=lr,
                                        weight_decay=weight_decay,
                                        grad_clip=grad_clip)
        self.lr_scheduler = lambda_lr(self.optimizer, self.schedule)
        self.loss_norm = torch.tensor(init_loss_norm, dtype=torch.float32,
                                      device=self.device)
        self.ema: Optional[ModelEma] = None
        self._points: Dict[int, torch.Tensor] = {}
        self._eval_model: Optional[ActionMambaDetector] = None
        self._eval_step = -1
        self._steps = 0
        self._epoch = -1

    def points(self, T: int) -> List[torch.Tensor]:
        """The point tables of the levels of a T-step input, on the
        device, built once per T."""
        if T not in self._points:
            self._points[T] = [
                torch.from_numpy(p).to(self.device)
                for p in self.point_gen(self.model.level_lengths(T))]
        return self._points[T]

    def init(self, feats=None) -> None:
        """Start the EMA from the current weights and build the point
        tables for ``feats``' length (the JAX ``init``: the weights
        themselves exist from the constructor on)."""
        self.ema = ModelEma(self.model, self.ema_decay)
        if feats is not None:
            self.points(feats.shape[1])

    def state_dict(self) -> dict:
        """What JAX ``save`` writes (parameters, EMA, optimizer state, the
        loss normaliser), and the schedule's and the generator's states
        and the step and epoch counts, so that a resumed run continues as
        the uninterrupted one would. Before the first step the EMA is the
        weights."""
        ema = self.ema or ModelEma(self.model, self.ema_decay)
        return dict(params=self.model.state_dict(), ema=ema.state_dict(),
                    opt_state=self.optimizer.state_dict(),
                    loss_norm=self.loss_norm,
                    lr_scheduler=self.lr_scheduler.state_dict(),
                    generator=self.generator.get_state(),
                    steps=self._steps, epoch=self._epoch)

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["params"])
        if self.ema is None:
            self.init()
        self.ema.load_state_dict(state["ema"])
        self.optimizer.load_state_dict(state["opt_state"])
        self.loss_norm = state["loss_norm"].to(self.device)
        self.lr_scheduler.load_state_dict(state["lr_scheduler"])
        load_generator_state(self.generator, state["generator"])
        self._steps, self._epoch = state["steps"], state["epoch"]
        self._eval_step = -1

    def _on(self, *arrays):
        return [torch.as_tensor(a).to(self.device) for a in arrays]

    def train_step(self, feats, mask, segs, labels, valid
                   ) -> Dict[str, float]:
        """One step on a batch from ``collate_tal`` (numpy arrays or
        tensors): labels assigned on the device, the losses, the backward,
        the clipped AdamW update and the EMA. Returns the losses before
        the update, read from the device once."""
        if self.ema is None:
            self.init(feats)
        feats, mask, segs, labels, valid = self._on(feats, mask, segs,
                                                    labels, valid)
        points = torch.cat(self.points(feats.shape[1]), dim=0)
        gt_cls, gt_off = label_points(
            points, segs.float(), labels, valid.bool(), self.num_classes,
            center_sample_radius=self.center_sample_radius)
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        cls_logits, offsets, fpn_masks = self.model(feats, mask,
                                                    self.generator)
        losses, self.loss_norm = tal_losses(
            fpn_masks, cls_logits, offsets, gt_cls, gt_off, self.loss_norm,
            self.num_classes, self.label_smoothing)
        losses["final_loss"].backward()
        self.optimizer.step()
        self.lr_scheduler.step()
        self.ema.update(self.model)
        self._steps += 1
        values = torch.stack([losses[k].detach() for k in LOSS_NAMES])
        return dict(zip(LOSS_NAMES, values.tolist()))

    def train_epoch(self, items: List[dict], batch_size: int = 2
                    ) -> Dict[str, float]:
        """One pass over ``items`` in an epoch-seeded order, in batches of
        ``batch_size`` (a last short batch is left out); the mean losses."""
        self._epoch += 1
        order = sharded_epoch_order(len(items), self._epoch)
        agg: Dict[str, float] = {}
        nb = 0
        for i in range(0, len(items), batch_size):
            chunk = [items[j] for j in order[i:i + batch_size]]
            if len(chunk) < batch_size:
                continue
            losses = self.train_step(*collate_tal(
                chunk, self.max_seq_len, self.max_num_gt, training=True))
            for k, v in losses.items():
                agg[k] = agg.get(k, 0.0) + v
            nb += 1
        return {k: v / max(nb, 1) for k, v in agg.items()}

    def inference_model(self, use_ema: bool = True) -> ActionMambaDetector:
        """The model in eval mode, holding the EMA weights with
        ``use_ema`` (a copy without gradients, refreshed after each train
        step)."""
        if not (use_ema and self.ema is not None):
            return self.model.eval()
        if self._eval_model is None:
            self._eval_model = copy.deepcopy(self.model)
            for p in self._eval_model.parameters():
                p.grad = None
                p.requires_grad_(False)
        if self._eval_step != self._steps:
            self.ema.copy_to(self._eval_model)
            self._eval_step = self._steps
        return self._eval_model.eval()

    def predict_video(self, item: dict, use_ema: bool = True) -> dict:
        """One video's detections in seconds: the forward, the decode,
        NMS per ``test_cfg``, then the feature grid to seconds, clipped
        to the video's duration."""
        model = self.inference_model(use_ema)
        feats, mask, *_ = collate_tal(
            [item], self.max_seq_len, self.max_num_gt, training=False,
            max_div_factor=(model.scale_factor
                            ** model.backbone_arch[2]))
        feats, mask = self._on(feats, mask)
        with torch.inference_mode():
            cls_logits, offsets, fpn_masks = model(feats, mask)
            segs, scores, cls_idxs = decode_single_video(
                self.points(feats.shape[1]), [m[0] for m in fpn_masks],
                [c[0] for c in cls_logits], [o[0] for o in offsets],
                self.test_cfg["pre_nms_thresh"],
                self.test_cfg["pre_nms_topk"],
                self.test_cfg["duration_thresh"])
        cfg = self.test_cfg
        if cfg["nms_method"] != "none":
            segs, scores, cls_idxs = batched_nms(
                segs, scores, cls_idxs, cfg["iou_threshold"],
                cfg["min_score"], cfg["max_seg_num"],
                use_soft_nms=cfg["nms_method"] == "soft",
                multiclass=cfg["multiclass_nms"], sigma=cfg["nms_sigma"],
                voting_thresh=cfg["voting_thresh"])
        if len(segs):
            segs = ((segs * item["feat_stride"]
                     + 0.5 * item["feat_num_frames"]) / item["fps"])
            segs = np.clip(segs, 0.0, float(item["duration"]))
        return dict(video_id=item["video_id"], segments=segs, scores=scores,
                    labels=cls_idxs)

    def evaluate(self, items: List[dict], tiou_thresholds=None,
                 use_ema: bool = True):
        """``predict_video`` over ``items`` and their mAP
        (``ANETdetection``): (mAP at each tIoU, average mAP)."""
        gt = {}
        for it in items:
            stride, nframes, fps = (it["feat_stride"],
                                    it["feat_num_frames"], it["fps"])
            gt[it["video_id"]] = [((s * stride + 0.5 * nframes) / fps,
                                   (e * stride + 0.5 * nframes) / fps,
                                   int(lab))
                                  for (s, e), lab in zip(it["segments"],
                                                         it["labels"])]
        evaluator = ANETdetection(gt, tiou_thresholds)
        vids, t0, t1, sc, lb = [], [], [], [], []
        for it in items:
            r = self.predict_video(it, use_ema=use_ema)
            for (s, e), score, lab in zip(r["segments"], r["scores"],
                                          r["labels"]):
                vids.append(r["video_id"])
                t0.append(s)
                t1.append(e)
                sc.append(score)
                lb.append(int(lab))
        return evaluator.evaluate({"video-id": vids, "t-start": np.array(t0),
                                   "t-end": np.array(t1),
                                   "score": np.array(sc),
                                   "label": np.array(lb)})


def build_tal_trainer(config: dict, device="cuda", seed: int = 0,
                      **overrides) -> TalTrainer:
    """A ``TalTrainer`` from a configuration of ``configs``
    (``TAL_THUMOS`` or ``TAL_ANET``): its dataset widths, model, recipe
    (``opt``: rate, weight decay, clip, EMA; warmup and total steps from
    its epochs times the training split's videos over the batch size),
    ``train_cfg`` (drop-path, loss normaliser, centre radius, smoothing)
    and ``test_cfg``. Random weights from ``seed``; ``overrides`` change
    any ``TalTrainer`` argument."""
    d, m, o, t = (config["dataset"], config["model"], config["opt"],
                  config["train_cfg"])
    steps_per_epoch = max(d["train_videos"]
                          // config["loader"]["batch_size"], 1)
    kw = dict(
        input_dim=d["input_dim"], num_classes=d["num_classes"],
        max_seq_len=d["max_seq_len"], embd_dim=m["embd_dim"],
        regression_range=m.get("regression_range"),
        backbone_arch=tuple(m["backbone_arch"]), mixer=m["mixer"],
        lr=o["learning_rate"], weight_decay=o["weight_decay"],
        warmup_steps=o["warmup_epochs"] * steps_per_epoch,
        total_steps=o["epochs"] * steps_per_epoch, grad_clip=o["grad_clip"],
        ema_decay=o["ema_decay"], label_smoothing=t["label_smoothing"],
        init_loss_norm=t["init_loss_norm"],
        center_sample_radius=t["center_sample_radius"],
        drop_path_rate=t["droppath"], test_cfg=config.get("test_cfg"),
        seed=seed, device=device)
    kw.update(overrides)
    return TalTrainer(**kw)
