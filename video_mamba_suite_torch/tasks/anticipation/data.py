"""Anticipation data (the port's own copy of the JAX package's
``tasks/anticipation/data.py``, numpy only): per-session feature files cut
into memory windows.

Each session has visual features ``{visual_dir}/{session}.npy`` (T, Dv),
optional motion features (T, Dm) and per-frame targets (T,) as class ids
or (T, C) one-hot or soft rows. A window is long + work memory frames of
features; its targets cover the work memory and the anticipation horizon.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np


class PerFrameDataset:
    """Windows over the sessions' ``.npy`` files, every ``stride`` frames;
    ``batches`` draws them in an order from a numpy generator seeded with
    ``seed``."""

    def __init__(self, sessions: Sequence[str], visual_dir: str,
                 motion_dir: Optional[str], target_dir: str,
                 long_memory: int = 8, work_memory: int = 6,
                 anticipation: int = 2, stride: int = 1, seed: int = 0):
        self.visual_dir = visual_dir
        self.motion_dir = motion_dir
        self.target_dir = target_dir
        self.long_memory = long_memory
        self.work_memory = work_memory
        self.anticipation = anticipation
        self.rng = np.random.default_rng(seed)
        self.windows: List[Tuple[str, int]] = []
        self._cache = {}
        span = long_memory + work_memory + anticipation
        for s in sessions:
            T = self._load(s)[0].shape[0]
            for start in range(0, max(T - span + 1, 0), stride):
                self.windows.append((s, start))

    def _load(self, session: str):
        if session not in self._cache:
            vis = np.load(os.path.join(self.visual_dir, session + ".npy"))
            mot = (np.load(os.path.join(self.motion_dir, session + ".npy"))
                   if self.motion_dir else
                   np.zeros((vis.shape[0], 1), np.float32))
            tgt = np.load(os.path.join(self.target_dir, session + ".npy"))
            if tgt.ndim == 2:  # one-hot or soft targets → class ids
                tgt = tgt.argmax(-1)
            self._cache[session] = (vis.astype(np.float32),
                                    mot.astype(np.float32),
                                    tgt.astype(np.int32))
        return self._cache[session]

    def __len__(self):
        return len(self.windows)

    def __getitem__(self, idx: int):
        """(visual (long + work, Dv), motion (long + work, Dm), targets
        (work + anticipation,))."""
        session, start = self.windows[idx]
        vis, mot, tgt = self._load(session)
        lm, wm, ant = self.long_memory, self.work_memory, self.anticipation
        sl = slice(start, start + lm + wm)
        t_sl = slice(start + lm, start + lm + wm + ant)
        return vis[sl], mot[sl], tgt[t_sl]

    def batches(self, batch_size: int, shuffle: bool = True):
        """Stacked (visual, motion, targets) batches of ``batch_size``
        windows, shuffled by the dataset's generator; a last partial batch
        is dropped."""
        order = (self.rng.permutation(len(self))
                 if shuffle else np.arange(len(self)))
        for i in range(0, len(order) - batch_size + 1, batch_size):
            rows = [self[j] for j in order[i:i + batch_size]]
            yield (np.stack([r[0] for r in rows]),
                   np.stack([r[1] for r in rows]),
                   np.stack([r[2] for r in rows]))
