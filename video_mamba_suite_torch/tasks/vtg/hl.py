"""Highlight detection on TVSum / YouTube-HL (the port's counterpart of the
JAX package's ``tasks/vtg/hl.py``, upstream main/train_hl.py,
config_hl.py and DatasetHL): the per-domain train / val splits,
saliency-only supervision (the MR span losses have no targets here), a
single zero text token where a sample has no query, and the TVSum
protocol's top-5 mAP averaged over the 20 annotators.

    trainer = build_hl_trainer(configs.VTG_TVSUM)
    losses = trainer.train_step(collate_hl(samples, 512, 512))
    m5 = tvsum_map_at_k(trainer.predict_scores(val), annos, k=5)

At the preset's 1 + 512 steps every DBM layer scans through K3 on the
card (K4 in the backward): 12 K3 and 12 K4 a step, 12 K3 a video.
``save`` / ``restore`` checkpoint the trainer's whole state.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ...data.sampler import sharded_epoch_order
from ...utils.trainer import Checkpointing
from .losses import unit_rows, weighted_bce
from .train import UniVtgTrainer

# Per-domain train / val video ids (upstream config_hl.py:149-210, the
# dataset's metadata).
TVSUM_SPLITS = {
    "BK": {"train": ["WxtbjNsCQ8A", "EE-bNr36nyA", "oDXZc0tZe04",
                     "uGu_10sucQo"], "val": ["Se3oxnaPsz0"]},
    "BT": {"train": ["eQu1rNs0an0", "qqR6AEXwxoQ", "EYqVtI9YWJA",
                     "iVt07TCkFM0"], "val": ["JgHubY5Vw3Y"]},
    "DS": {"train": ["kLxoNp-UchI", "NyBmCxDoHJU", "jcoYJXDG9sw",
                     "-esJrBWj2d8"], "val": ["E11zDS9XGzg"]},
    "FM": {"train": ["_xMr-HKMfVA", "byxOvuiIJV0", "VuWGsYPqAX8",
                     "JKpqYvAdIsw"], "val": ["xmEERLqJ2kU"]},
    "GA": {"train": ["xxdtq8mxegs", "i3wAGJaaktw", "0tmA_C6XwfM",
                     "3eYKfiOEJNs"], "val": ["Bhxk-O1Y7Ho"]},
    "MS": {"train": ["Hl-__g2gn_A", "WG0MBPpPC6I", "LRw_obCPUt0",
                     "37rzWOQsNIw"], "val": ["Yi4Ij2NM7U4"]},
    "PK": {"train": ["GsAD1KT1xo8", "XkqCExn6_Us", "b626MiF1ew4",
                     "PJrm840pAUI"], "val": ["cjibtmSLxQ4"]},
    "PR": {"train": ["RBCABdttQmI", "z_6gVvQb2d0", "4wU_LUjG5Ic",
                     "91IHQYk1IQM"], "val": ["fWutDQy1nnY"]},
    "VT": {"train": ["gzDbaEs1Rlg", "XzYM3PfTM4w", "98MoyGZKHXc",
                     "AwmHb44_ouw"], "val": ["J0nA4VgnoCo"]},
    "VU": {"train": ["akI8YFjEmUw", "HT5vyqe0Xaw", "vdmoEJ5YbrQ",
                     "xwqBXPGE9pQ"], "val": ["sTEELN-vY30"]},
}

HL_LOSS_WEIGHTS = dict(loss_f=4.0, loss_s_intra=0.1)


def hl_losses(outputs: Dict[str, torch.Tensor],
              targets: Dict[str, torch.Tensor], eos_coef: float = 0.1,
              temperature: float = 0.07,
              weights: Optional[Dict[str, float]] = None
              ) -> Dict[str, torch.Tensor]:
    """The saliency-only objective: loss_f, the foreground BCE against the
    clips above each video's median saliency, and loss_s_intra, the
    within-video InfoNCE of the sampled positive clip over lower-scored
    clips; loss_total under ``weights`` (default ``HL_LOSS_WEIGHTS``,
    upstream config.py's HL coefficients).

    targets: vid_mask (B, Lv), saliency_scores (B, Lv),
    saliency_pos_labels (B,). The median is taken as ``jnp.median`` of the
    scores with NaN at padded clips: NaN in a padded row, which becomes
    0."""
    weights = weights or HL_LOSS_WEIGHTS
    out: Dict[str, torch.Tensor] = {}
    mask = targets["vid_mask"].float()                          # (B, Lv)
    sal = targets["saliency_scores"].float()                    # (B, Lv)
    med = torch.quantile(torch.where(mask > 0, sal, torch.nan), 0.5, dim=1,
                         keepdim=True).nan_to_num()
    tgt = (sal > med).float() * mask
    bce = weighted_bce(outputs["pred_logits"][..., 0], tgt, mask, eos_coef)
    out["loss_f"] = bce.sum() / mask.sum().clamp_min(1.0)

    vid_mem = outputs["vid_mem_proj"].float()                   # (B, Lv, D)
    txt = outputs["txt_mem_proj"][:, 0].float()                 # (B, D)
    pos_idx = targets["saliency_pos_labels"].long()             # (B,)
    bidx = torch.arange(vid_mem.shape[0], device=vid_mem.device)
    sim = (unit_rows(vid_mem) * unit_rows(txt)[:, None]).sum(dim=-1)
    neg_in = sal < sal[bidx, pos_idx][:, None]
    neg_in[bidx, pos_idx] = True
    sim = sim + torch.where(neg_in & (mask > 0), 0.0, -1e4)
    logsm = torch.log_softmax(sim / temperature, dim=1)
    out["loss_s_intra"] = -logsm[bidx, pos_idx].mean()

    out["loss_total"] = sum(out[k] * weights.get(k, 1.0) for k in list(out))
    return out


def collate_hl(samples: List[dict], max_v_l: int, txt_dim: int) -> Dict:
    """samples [{vid_feat (T, D), saliency (T,), txt_feat (Lq, Dt) or
    absent}] → padded numpy arrays: the saliency padded with -1 (never
    a positive), one text token (the query's first, or zeros), the
    positive clip drawn among those with saliency > 0 by a generator
    seeded 0 on each call."""
    B = len(samples)
    vid_dim = samples[0]["vid_feat"].shape[-1]
    src_vid = np.zeros((B, max_v_l, vid_dim), np.float32)
    vid_mask = np.zeros((B, max_v_l), np.float32)
    sal = np.full((B, max_v_l), -1.0, np.float32)
    src_txt = np.zeros((B, 1, txt_dim), np.float32)
    txt_mask = np.ones((B, 1), np.float32)
    pos = np.zeros((B,), np.int32)
    rng = np.random.default_rng(0)
    for i, s in enumerate(samples):
        T = min(len(s["vid_feat"]), max_v_l)
        src_vid[i, :T] = s["vid_feat"][:T]
        vid_mask[i, :T] = 1.0
        sal[i, :T] = s["saliency"][:T]
        if s.get("txt_feat") is not None:
            src_txt[i, 0] = s["txt_feat"][:1]
        cand = np.where(s["saliency"][:T] > 0)[0]
        pos[i] = int(rng.choice(cand)) if len(cand) else 0
    return dict(src_txt=src_txt, src_txt_mask=txt_mask, src_vid=src_vid,
                src_vid_mask=vid_mask, saliency_scores=sal,
                saliency_pos_labels=pos, vid_mask=vid_mask)


HL_TARGET_KEYS = ("vid_mask", "saliency_scores", "saliency_pos_labels")


class HlTrainer(Checkpointing, UniVtgTrainer):
    """The JAX ``HlTrainer``: UniVTG-Mamba (input dropout 0.5, drop-path
    0.1, the model's defaults) trained on one domain with ``hl_losses`` on
    ``collate_hl`` batches, AdamW clipped at ``grad_clip``; eval scores
    are saliency + foreground probability (``eval_mode`` "add", upstream
    train_hl.py:53-61) or the probability alone."""

    def __init__(self, txt_dim: int, vid_dim: int, embed_dim: int = 256,
                 depth: int = 4, mamba_type: str = "vim", lr: float = 1e-4,
                 weight_decay: float = 1e-4, grad_clip: float = 0.1,
                 max_v_l: int = 512, seed: int = 0, use_mesh: bool = False,
                 eval_mode: str = "add", device="cuda"):
        super().__init__(dict(txt_dim=txt_dim, vid_dim=vid_dim,
                              embed_dim=embed_dim, depth=depth,
                              mamba_type=mamba_type),
                         lr, weight_decay, grad_clip, seed, device, use_mesh)
        self.txt_dim, self.max_v_l = txt_dim, max_v_l
        self.eval_mode = eval_mode

    def loss(self, out: Dict, batch: Dict) -> Dict[str, torch.Tensor]:
        return hl_losses(out, self._on(batch, HL_TARGET_KEYS))

    def train_epoch(self, samples: List[dict], batch_size: int = 4
                    ) -> Dict[str, float]:
        """One pass over ``samples`` in the epoch's seeded order; returns
        the last batch's losses (as the JAX trainer)."""
        self._epoch += 1
        order = sharded_epoch_order(len(samples), self._epoch)
        losses: Dict[str, float] = {}
        for i in range(0, len(samples), batch_size):
            losses = self.train_step(collate_hl(
                [samples[j] for j in order[i:i + batch_size]],
                self.max_v_l, self.txt_dim))
        return losses

    def predict_scores(self, samples: List[dict]) -> List[np.ndarray]:
        """Each video's clip scores, one video a forward in eval mode."""
        outs = []
        for s in samples:
            batch = collate_hl([s], self.max_v_l, self.txt_dim)
            with torch.inference_mode():
                out = self.forward(batch)
                host = torch.stack([out["saliency_scores"][0],
                                    out["pred_logits"][0, :, 0]]
                                   ).float().cpu().numpy()
            T = min(len(s["vid_feat"]), self.max_v_l)
            sal, logit = host[0, :T], host[1, :T]
            outs.append(sal + logit if self.eval_mode == "add" else logit)
        return outs


def build_hl_trainer(config: dict, device="cuda", seed: int = 0,
                     **overrides) -> HlTrainer:
    """An ``HlTrainer`` from a highlight-detection configuration of
    ``configs`` (``VTG_TVSUM``) read as the JAX CLI reads it: text width
    ``dataset.t_feat_dim``, video width ``dataset.v_feat_dim`` (the
    data's), the model's width, depth, mixer and ``max_v_l`` (128 when
    absent), the learning rate. Random weights from ``seed``;
    ``overrides`` change any ``HlTrainer`` argument. The batch size is
    ``config["loader"]["batch_size"]``, the caller's."""
    m, d = config["model"], config["dataset"]
    kw = dict(txt_dim=d.get("t_feat_dim", 512), vid_dim=d["v_feat_dim"],
              embed_dim=m.get("embed_dim", 256), depth=m.get("depth", 4),
              mamba_type=m.get("mamba_type", "vim"),
              lr=config["opt"]["learning_rate"],
              max_v_l=m.get("max_v_l", 128), seed=seed, device=device)
    kw.update(overrides)
    return HlTrainer(**kw)


def tvsum_map_at_k(scores: List[np.ndarray], annos: List[np.ndarray],
                   k: int = 5) -> float:
    """TVSum protocol (upstream main/dataset.py:900-930): for each of the annotators,
    binarize each video's per-clip labels at > median, rank clips by the
    predicted score, and compute AP over the top-k; average over videos,
    then annotators. annos[i]: (T_i, n_annotators)."""
    n_ann = annos[0].shape[1]
    maps = []
    for a in range(n_ann):
        aps = []
        for score, anno in zip(scores, annos):
            lab = anno[:, a].astype(np.float32)
            lab = (lab > np.median(lab)).astype(np.float32)
            order = np.argsort(-score)
            top = lab[order][:k]
            num_gt = top.sum()
            if num_gt == 0:
                aps.append(0.0)
                continue
            hits = ap = rec = 0.0
            prc = 1.0
            for j, g in enumerate(top):
                hits += g
                _rec = hits / num_gt
                _prc = hits / (j + 1)
                ap += (_rec - rec) * (prc + _prc) / 2
                rec, prc = _rec, _prc
            aps.append(ap)
        maps.append(float(np.mean(aps)))
    return float(np.mean(maps))
