"""Action segmentation data (the port's own copy of the JAX package's
``tasks/tas/data.py``, host numpy): ``.npy`` frame features (C, L), text
ground-truth files read through an actions dict, every ``sample_rate``-th
frame, padding to the batch's longest video (or a multiple of ``pad_to``)
with targets ``IGNORE_INDEX`` and a frame mask, the time-warp
augmentation, and synthetic videos."""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

IGNORE_INDEX = -100


def time_warp(features: np.ndarray, labels: np.ndarray,
              rng: np.random.Generator, num_knots: int = 10
              ) -> Tuple[np.ndarray, np.ndarray]:
    """A smooth monotone warp of time through ``num_knots`` sorted random
    knots: features (C, L) interpolated linearly, labels (L,) taken at the
    nearest frame."""
    L = features.shape[1]
    knots = np.concatenate([[0.0], np.sort(rng.uniform(0, 1, num_knots)),
                            [1.0]])
    vals = np.concatenate([[0.0], np.sort(rng.uniform(0, 1, num_knots)),
                           [1.0]])
    warped_t = np.interp(np.linspace(0, 1, L), knots, vals) * (L - 1)
    lo = np.floor(warped_t).astype(int)
    hi = np.minimum(lo + 1, L - 1)
    w = warped_t - lo
    feats = features[:, lo] * (1 - w)[None] + features[:, hi] * w[None]
    labs = labels[np.round(warped_t).astype(int)]
    return feats.astype(features.dtype), labs


class TasBatchGenerator:
    """Batches of videos read from files: ``features_path/<video>.npy``
    (C, L) and ``gt_path/<video file>`` (one action name a line, mapped
    through ``actions_dict``), cut to the shorter of the two, every
    ``sample_rate``-th frame. The video list is shuffled by a numpy
    generator seeded with ``seed`` at ``read_data`` and every ``reset``;
    the same generator draws the time warps."""

    def __init__(self, num_classes: int, actions_dict: Dict[str, int],
                 gt_path: str, features_path: str, sample_rate: int = 1,
                 pad_to: Optional[int] = None, seed: int = 0):
        self.num_classes = num_classes
        self.actions_dict = actions_dict
        self.gt_path = gt_path
        self.features_path = features_path
        self.sample_rate = sample_rate
        self.pad_to = pad_to
        self.index = 0
        self.list_of_examples: List[str] = []
        self.rng = np.random.default_rng(seed)

    def read_data(self, vid_list_file: str):
        with open(vid_list_file) as f:
            self.list_of_examples = [l for l in f.read().split("\n") if l]
        self.shuffle()

    def shuffle(self):
        perm = self.rng.permutation(len(self.list_of_examples))
        self.list_of_examples = [self.list_of_examples[i] for i in perm]

    def reset(self):
        self.index = 0
        self.shuffle()

    def has_next(self) -> bool:
        return self.index < len(self.list_of_examples)

    def _load_one(self, vid: str) -> Tuple[np.ndarray, np.ndarray]:
        feats = np.load(os.path.join(self.features_path,
                                     vid.split(".")[0] + ".npy"))
        with open(os.path.join(self.gt_path, vid)) as f:
            content = [l for l in f.read().split("\n") if l]
        n = min(feats.shape[1], len(content))
        classes = np.array([self.actions_dict[c] for c in content[:n]],
                           np.int64)
        return (feats[:, :n][:, ::self.sample_rate],
                classes[::self.sample_rate])

    def next_batch(self, batch_size: int, if_warp: bool = False):
        """(features (B, L, C), targets (B, L), mask (B, L), video
        names) of the next ``batch_size`` videos, time-warped with
        ``if_warp``."""
        batch_vids = self.list_of_examples[self.index:self.index
                                           + batch_size]
        self.index += batch_size
        items = [self._load_one(v) for v in batch_vids]
        if if_warp:
            items = [time_warp(f, l, self.rng) for f, l in items]
        return collate(items, self.pad_to) + (batch_vids,)


def collate(items: Sequence[Tuple[np.ndarray, np.ndarray]],
            pad_to: Optional[int] = None):
    """(C, L) features and (L,) labels padded to the batch's longest video,
    rounded up to a multiple of ``pad_to`` if given: (features (B, L, C)
    fp32, targets (B, L) int64 with ``IGNORE_INDEX`` at the padding, mask
    (B, L) fp32)."""
    lengths = [len(l) for _, l in items]
    maxlen = max(lengths)
    if pad_to:
        maxlen = -(-maxlen // pad_to) * pad_to
    C = items[0][0].shape[0]
    B = len(items)
    feats = np.zeros((B, maxlen, C), np.float32)
    targets = np.full((B, maxlen), IGNORE_INDEX, np.int64)
    mask = np.zeros((B, maxlen), np.float32)
    for i, (f, l) in enumerate(items):
        n = len(l)
        feats[i, :n] = f[:, :n].T
        targets[i, :n] = l
        mask[i, :n] = 1.0
    return feats, targets, mask


def make_synthetic_dataset(
    num_videos: int = 8, num_classes: int = 5, feat_dim: int = 32,
    min_len: int = 40, max_len: int = 90, seed: int = 0,
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Synthetic videos with structure to learn: a prototype feature vector
    per class plus noise, labels in runs of 5 to 14 frames. Returns
    [(features (feat_dim, L) fp32, labels (L,))]."""
    rng = np.random.default_rng(seed)
    protos = rng.standard_normal((num_classes, feat_dim)) * 2.0
    items = []
    for _ in range(num_videos):
        L = int(rng.integers(min_len, max_len))
        labels = []
        while len(labels) < L:
            c = int(rng.integers(num_classes))
            labels += [c] * int(rng.integers(5, 15))
        labels = np.array(labels[:L])
        feats = protos[labels].T + 0.3 * rng.standard_normal((feat_dim, L))
        items.append((feats.astype(np.float32), labels))
    return items
