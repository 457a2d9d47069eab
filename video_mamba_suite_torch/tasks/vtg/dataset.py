"""Moment-retrieval data from files (the port's own copy of the JAX
package's ``tasks/vtg/dataset.py``, host numpy; upstream DatasetMR,
main/dataset.py:410-560): jsonl metadata ({qid, query, duration, vid,
relevant_windows, saliency_scores, ...}), video features from one or more
directories (``.npy`` or ``.npz``, concatenated on the channels), query
features per qid, optional temporal endpoint features (tef) and row
normalization, targets through ``data.build_targets``.
"""

from __future__ import annotations

import os
from typing import Dict, Sequence

import numpy as np

from .data import build_targets, load_jsonl_dataset


class VtgDataset:
    def __init__(
        self,
        data_path: str,
        v_feat_dirs: Sequence[str],
        q_feat_dir: str,
        max_q_l: int = 32,
        max_v_l: int = 75,
        clip_len: float = 2.0,
        use_tef: bool = True,
        normalize: bool = True,
        seed: int = 0,
    ):
        self.data = load_jsonl_dataset(data_path)
        self.v_feat_dirs = list(v_feat_dirs)
        self.q_feat_dir = q_feat_dir
        self.max_q_l = max_q_l
        self.max_v_l = max_v_l
        self.clip_len = clip_len
        self.use_tef = use_tef
        self.normalize = normalize
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.data)

    @staticmethod
    def _load(path: str) -> np.ndarray:
        if path.endswith(".npz"):
            return np.load(path)["features"].astype(np.float32)
        return np.load(path).astype(np.float32)

    def _video_feat(self, vid: str) -> np.ndarray:
        parts = []
        for d in self.v_feat_dirs:
            for ext in (".npy", ".npz"):
                p = os.path.join(d, vid + ext)
                if os.path.exists(p):
                    parts.append(self._load(p))
                    break
        n = min(p.shape[0] for p in parts)
        feat = np.concatenate([p[:n] for p in parts], axis=1)
        if self.normalize:
            feat = feat / np.maximum(
                np.linalg.norm(feat, axis=-1, keepdims=True), 1e-5
            )
        return feat[: self.max_v_l]

    def _query_feat(self, qid) -> np.ndarray:
        for name in (f"qid{qid}.npz", f"qid{qid}.npy", f"{qid}.npz",
                     f"{qid}.npy"):
            p = os.path.join(self.q_feat_dir, name)
            if os.path.exists(p):
                break
        feat = self._load(p)
        if feat.ndim == 1:
            feat = feat[None]
        if self.normalize:
            feat = feat / np.maximum(
                np.linalg.norm(feat, axis=-1, keepdims=True), 1e-5
            )
        return feat[: self.max_q_l]

    def __getitem__(self, idx: int) -> Dict:
        meta = self.data[idx]
        vid_feat = self._video_feat(meta["vid"])
        ctx_l = len(vid_feat)
        if self.use_tef:
            st = np.arange(ctx_l, dtype=np.float32) / ctx_l
            tef = np.stack([st, st + 1.0 / ctx_l], axis=1)
            vid_feat = np.concatenate([vid_feat, tef], axis=1)
        txt_feat = self._query_feat(meta["qid"])
        sal = None
        if "saliency_scores" in meta and "relevant_clip_ids" in meta:
            sal = np.zeros(ctx_l, np.float32)
            ids = [i for i in meta["relevant_clip_ids"] if i < ctx_l]
            sc = np.asarray(meta["saliency_scores"][: len(ids)], np.float64)
            if sc.ndim == 2:
                sc = sc.mean(-1)
            sal[ids] = sc[: len(ids)]
        targets = build_targets(
            ctx_l, meta["relevant_windows"], self.clip_len,
            saliency_scores=sal, rng=self.rng,
        )
        return dict(
            qid=meta["qid"], txt_feat=txt_feat, vid_feat=vid_feat,
            targets=targets, relevant_windows=meta["relevant_windows"],
            duration=meta.get("duration", ctx_l * self.clip_len),
            clip_len=self.clip_len,
        )
