"""TAL data: pre-extracted features with segment annotations (the port's
copy of the JAX package's ``tasks/tal/data.py``): random truncation,
the json + feature-folder dataset, collation to a fixed length with the
ground truth padded to ``max_num_gt``, and synthetic videos.

Feature files are .npy (C, T), or torch .pt files. Everything here is
numpy on the host; the trainer stages a batch on its device.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def truncate_feats(feats: np.ndarray, segments: np.ndarray,
                   labels: np.ndarray, max_seq_len: int,
                   trunc_thresh: float, rng: np.random.Generator,
                   crop_ratio: Optional[Sequence[float]] = None,
                   max_num_trials: int = 200
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A random window of at most ``max_seq_len`` steps of feats (C, T)
    that keeps the actions overlapping it by more than ``trunc_thresh``
    of their length (segments (N, 2) on the feature grid); a video no
    longer than that is cropped to ``crop_ratio`` of its length when
    given."""
    T = feats.shape[1]
    max_len = max_seq_len
    if T <= max_len:
        if crop_ratio is None:
            return feats, segments, labels
        max_len = min(int(round(T * rng.uniform(*crop_ratio))), T)
        if max_len == T:
            return feats, segments, labels
    for _ in range(max_num_trials):
        st = int(rng.integers(0, T - max_len + 1))
        ed = st + max_len
        if len(segments) == 0:
            return feats[:, st:ed], segments, labels
        left = np.maximum(segments[:, 0], st)
        right = np.minimum(segments[:, 1], ed)
        inter = np.clip(right - left, 0, None)
        lens = segments[:, 1] - segments[:, 0]
        seg_idx = inter / np.maximum(lens, 1e-8) > trunc_thresh
        if seg_idx.any():
            new_segs = np.stack(
                [np.clip(segments[seg_idx, 0] - st, 0, max_len),
                 np.clip(segments[seg_idx, 1] - st, 0, max_len)], axis=1)
            return feats[:, st:ed], new_segs, labels[seg_idx]
    # no window kept an action: the first, with what overlaps it
    st, ed = 0, max_len
    keep = (segments[:, 1] > st) & (segments[:, 0] < ed)
    new_segs = np.stack([np.clip(segments[keep, 0] - st, 0, max_len),
                         np.clip(segments[keep, 1] - st, 0, max_len)],
                        axis=1)
    return feats[:, st:ed], new_segs, labels[keep]


class TalDataset:
    """Videos of a json annotation file ({"database": {video: {"subset",
    "duration", "fps", "annotations": [{"segment": [s, e] in seconds,
    "label_id"}]}}}) in the subsets ``split``, with their features from
    ``feat_folder``. Segments go from seconds to the feature grid as
    (t · fps − num_frames / 2) / feat_stride; training items are
    truncated (``truncate_feats``)."""

    def __init__(self, json_file: str, feat_folder: str,
                 split: Sequence[str], feat_stride: int = 4,
                 num_frames: int = 16, default_fps: Optional[float] = None,
                 file_ext: str = ".npy", max_seq_len: int = 2304,
                 trunc_thresh: float = 0.5,
                 crop_ratio: Optional[Sequence[float]] = (0.9, 1.0),
                 is_training: bool = True, seed: int = 0):
        self.feat_folder = feat_folder
        self.feat_stride = feat_stride
        self.num_frames = num_frames
        self.file_ext = file_ext
        self.max_seq_len = max_seq_len
        self.trunc_thresh = trunc_thresh
        self.crop_ratio = crop_ratio
        self.is_training = is_training
        self.rng = np.random.default_rng(seed)
        with open(json_file) as f:
            db = json.load(f)["database"]
        self.items = [dict(video_id=vid, fps=v.get("fps", default_fps),
                           duration=v["duration"],
                           annotations=v.get("annotations", []))
                      for vid, v in db.items() if v.get("subset") in split]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx: int) -> Dict:
        it = self.items[idx]
        path = os.path.join(self.feat_folder, it["video_id"] + self.file_ext)
        if self.file_ext == ".npy":
            feats = np.load(path).astype(np.float32)
        else:
            import torch

            feats = torch.load(path, map_location="cpu",
                               weights_only=True).numpy().astype(np.float32)
        if feats.shape[0] > feats.shape[1]:
            feats = feats.T                              # to (C, T)
        fps = it["fps"]
        segs = [[(s * fps - 0.5 * self.num_frames) / self.feat_stride,
                 (e * fps - 0.5 * self.num_frames) / self.feat_stride]
                for s, e in (a["segment"] for a in it["annotations"])]
        segments = np.asarray(segs, np.float64).reshape(-1, 2)
        labels = np.asarray([a["label_id"] for a in it["annotations"]],
                            np.int64)
        if self.is_training:
            feats, segments, labels = truncate_feats(
                feats, segments, labels, self.max_seq_len,
                self.trunc_thresh, self.rng, self.crop_ratio)
        return dict(feats=feats, segments=segments, labels=labels,
                    video_id=it["video_id"], fps=fps,
                    duration=it["duration"], feat_stride=self.feat_stride,
                    feat_num_frames=self.num_frames)


def collate_tal(items: List[Dict], max_seq_len: int, max_num_gt: int,
                training: bool = True, max_div_factor: int = 32):
    """numpy (feats (B, T, C), mask (B, T), segments (B, max_num_gt, 2),
    labels (B, max_num_gt), valid (B, max_num_gt)). T is ``max_seq_len``
    in training; at eval the longest video, at least ``max_seq_len``,
    rounded up to a multiple of ``max_div_factor``."""
    B = len(items)
    C = items[0]["feats"].shape[0]
    lens = [it["feats"].shape[1] for it in items]
    if training:
        assert max(lens) <= max_seq_len
        T = max_seq_len
    else:
        T = max(max(lens), max_seq_len)
        T = -(-T // max_div_factor) * max_div_factor
    feats = np.zeros((B, T, C), np.float32)
    mask = np.zeros((B, T), np.float32)
    segs = np.zeros((B, max_num_gt, 2), np.float32)
    labels = np.zeros((B, max_num_gt), np.int32)
    valid = np.zeros((B, max_num_gt), bool)
    for i, it in enumerate(items):
        t = it["feats"].shape[1]
        feats[i, :t] = it["feats"].T
        mask[i, :t] = 1.0
        n = min(len(it["segments"]), max_num_gt)
        if n:
            segs[i, :n] = it["segments"][:n]
            labels[i, :n] = it["labels"][:n]
            valid[i, :n] = True
    return feats, mask, segs, labels, valid


def make_synthetic_tal(num_videos: int = 6, num_classes: int = 3,
                       feat_dim: int = 16, seq_len: int = 192,
                       seed: int = 0) -> List[Dict]:
    """Synthetic videos: 1 to 3 actions each, class-prototype bumps of 12
    to 29 steps on a noise floor (the JAX package's generator, the same
    values for the same seed)."""
    rng = np.random.default_rng(seed)
    protos = rng.standard_normal((num_classes, feat_dim)) * 2.5
    items = []
    for v in range(num_videos):
        feats = 0.3 * rng.standard_normal((feat_dim, seq_len)).astype(
            np.float32)
        segs, labels = [], []
        for _ in range(int(rng.integers(1, 4))):
            c = int(rng.integers(num_classes))
            start = int(rng.integers(0, seq_len - 30))
            end = min(start + int(rng.integers(12, 30)), seq_len)
            feats[:, start:end] += protos[c][:, None]
            segs.append([start, end])
            labels.append(c)
        items.append(dict(
            feats=feats, segments=np.asarray(segs, np.float64),
            labels=np.asarray(labels, np.int64), video_id=f"v{v}",
            fps=30.0, duration=seq_len / 30.0, feat_stride=1,
            feat_num_frames=1))
    return items
