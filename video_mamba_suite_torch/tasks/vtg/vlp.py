"""Video-language pretraining for UniVTG-Mamba (the port's counterpart of
the JAX package's ``tasks/vtg/vlp.py``; upstream main/train_vlp.py and
DatasetVLP): the MR model and criterion trained over point, interval and
curve grounding samples, and zero-shot class scores from class-name
tokens pooled by the text projector and pool (the model's ``src_cls``
path). The per-type ``weight_ablation`` vector is produced, as upstream's
dataset does, and unused, as upstream's criterion leaves it.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from .data import build_targets, collate_vtg
from .train import VtgTrainer


def build_vlp_sample(ctx_l: int, vid_dim: int, txt_dim: int, q_l: int,
                     sample_type: str, rng: np.random.Generator,
                     clip_len: float = 1.0) -> dict:
    """One VLP sample in the MR schema, per DatasetVLP's type branches:
      * 'point'    — a single timestamp widened to one clip (upstream
                     main/dataset.py:171-177 minimum-width fix);
      * 'interval' — an MR-style relevant window;
      * 'curve'    — a continuous saliency curve; windows from its support.
    """
    vid = rng.standard_normal((ctx_l, vid_dim)).astype(np.float32)
    txt = rng.standard_normal((q_l, txt_dim)).astype(np.float32)
    duration = ctx_l * clip_len
    sal = None
    if sample_type == "point":
        t = float(rng.uniform(0, duration - clip_len))
        center = t + clip_len / 2
        windows = [[max(0.0, center - 0.5 * clip_len),
                    min(duration, center + 0.5 * clip_len)]]
        ablation = [0, 0, 1, 0, 0]
    elif sample_type == "interval":
        s = float(rng.uniform(0, duration * 0.6))
        e = float(rng.uniform(s + clip_len, min(duration, s + duration * 0.4)))
        windows = [[s, e]]
        ablation = [1, 1, 0, 0, 0]
    elif sample_type == "curve":
        sal = np.clip(rng.standard_normal(ctx_l) * 0.3 + 0.3, 0, 1)
        thr = sal > 0.5
        if not thr.any():
            thr[int(rng.integers(ctx_l))] = True
        idx = np.nonzero(thr)[0]
        windows = [[float(idx[0]) * clip_len, float(idx[-1] + 1) * clip_len]]
        sal = sal.astype(np.float32)
        ablation = [0, 0, 0, 1, 1]
    else:
        raise ValueError(sample_type)

    targets = build_targets(ctx_l, windows, clip_len,
                            saliency_scores=sal, rng=rng)
    return dict(
        qid=int(rng.integers(1 << 30)), vid_feat=vid, txt_feat=txt,
        duration=duration, relevant_windows=windows, targets=targets,
        type=sample_type, weight_ablation=np.asarray(ablation, np.float32),
    )


def make_synthetic_vlp(num_samples: int = 9, ctx_l: int = 32,
                       vid_dim: int = 12, txt_dim: int = 12, q_l: int = 4,
                       seed: int = 0,
                       types=("point", "interval", "curve")) -> List[dict]:
    rng = np.random.default_rng(seed)
    return [
        build_vlp_sample(ctx_l, vid_dim, txt_dim, q_l,
                         types[i % len(types)], rng)
        for i in range(num_samples)
    ]


class VlpPretrainer(VtgTrainer):
    """VLP pretraining: ``VtgTrainer`` over VLP-schema samples (upstream
    train_vlp.py trains the same model and criterion), with
    ``zero_shot_class_scores``."""

    def zero_shot_class_scores(self, samples: List[dict],
                               cls_feats: np.ndarray,
                               cls_mask: Optional[np.ndarray] = None
                               ) -> np.ndarray:
        """The cosine of each clip's projection against each pooled
        class-name embedding, (B, Lv, C), in eval mode. cls_feats (C, Lc,
        Dt) are class-name token features; cls_mask (C, Lc), all ones by
        default."""
        batch = collate_vtg(samples, self.max_q_l, self.max_v_l)
        if cls_mask is None:
            cls_mask = np.ones(cls_feats.shape[:2], np.float32)
        cls_feats, cls_mask = (torch.as_tensor(a).to(self.device)
                               for a in (cls_feats, cls_mask))
        with torch.inference_mode():
            out = self.forward(batch, src_cls=cls_feats,
                               src_cls_mask=cls_mask)
            vid = out["vid_mem_proj"].float().cpu().numpy()     # (B, Lv, D)
            cls = out["cls_mem_proj"].float().cpu().numpy()     # (C, D)
        vidn = vid / np.maximum(
            np.linalg.norm(vid, axis=-1, keepdims=True), 1e-8)
        clsn = cls / np.maximum(
            np.linalg.norm(cls, axis=-1, keepdims=True), 1e-8)
        return np.einsum("bld,cd->blc", vidn, clsn)

