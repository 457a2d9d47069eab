"""Raw-video datasets: classification (Kinetics-style) and video-text
pairs (the port's own copy of the JAX package's ``data/video_datasets.py``).

The upstream loaders they follow: action-recognition's
``datasets/kinetics_sparse.py`` (a csv of ``path label``, segment-uniform
sparse sampling, multi-view test) and egocentric ``avion/data/
clip_dataset.py`` (video and narration pairs, a retry with another random
item on a decode error). Frames decode through ``data.video.VideoDecoder``
on the host; the transforms run on the device (``preprocess_clip``).
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .video import VideoDecoder, sample_frame_indices


class VideoClassificationDataset:
    """csv rows `path,label` (or space-separated) → sparse-sampled clips.

    kinetics_sparse.py semantics: training samples one random frame per
    segment; test enumerates num_clips temporal views (deterministic).
    """

    def __init__(self, csv_path: str, video_root: str = "",
                 num_frames: int = 16, num_clips: int = 1,
                 is_training: bool = True, retries: int = 3, seed: int = 0):
        self.items: List[Tuple[str, int]] = []
        with open(csv_path) as f:
            text = f.read().strip().splitlines()
        for line in text:
            parts = line.replace(",", " ").split()
            if len(parts) >= 2:
                self.items.append((os.path.join(video_root, parts[0]),
                                   int(parts[-1])))
        self.num_frames = num_frames
        self.num_clips = num_clips
        self.is_training = is_training
        self.retries = retries
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx: int) -> Dict:
        """Returns {'frames': (V, T, H, W, 3) uint8, 'label': int,
        'video_id': str} with V = 1 (train) or num_clips (test)."""
        path, label = self.items[idx]
        last_err = None
        for attempt in range(self.retries):
            try:
                dec = VideoDecoder(path)
                views = []
                n_views = 1 if self.is_training else self.num_clips
                for v in range(n_views):
                    ids = sample_frame_indices(
                        self.num_frames, dec.num_frames, mode="sparse",
                        clip_idx=v, num_clips=self.num_clips,
                        rng=self.rng if self.is_training else None,
                    )
                    views.append(dec.get_batch(ids))
                return dict(frames=np.stack(views), label=label,
                            video_id=os.path.basename(path))
            except Exception as e:  # decode-error retry (clip_dataset.py:84)
                last_err = e
                idx = int(self.rng.integers(len(self.items)))
                path, label = self.items[idx]
        raise RuntimeError(f"video decode failed after retries: {last_err}")


class VideoCaptionDataset:
    """Video + narration pairs for CLIP pretraining (clip_dataset.py:280):
    metadata rows {video, start, end, caption}; clip frames sampled
    uniformly inside [start, end]."""

    def __init__(self, metadata: Sequence[dict], video_root: str = "",
                 num_frames: int = 4, tokenizer: Optional[Callable] = None,
                 is_training: bool = True, retries: int = 3, seed: int = 0):
        self.metadata = list(metadata)
        self.video_root = video_root
        self.num_frames = num_frames
        self.tokenizer = tokenizer
        self.is_training = is_training
        self.retries = retries
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.metadata)

    def __getitem__(self, idx: int) -> Dict:
        m = self.metadata[idx]
        last_err = None
        for _ in range(self.retries):
            try:
                dec = VideoDecoder(os.path.join(self.video_root, m["video"]))
                fps = dec.fps or 30.0
                s = int(m.get("start", 0) * fps)
                e = int(m.get("end", dec.num_frames / fps) * fps)
                e = min(max(e, s + 1), dec.num_frames)
                span = e - s
                ids = s + sample_frame_indices(
                    self.num_frames, span, mode="sparse",
                    rng=self.rng if self.is_training else None,
                )
                frames = dec.get_batch(np.clip(ids, 0, dec.num_frames - 1))
                out = dict(frames=frames, caption=m["caption"])
                if self.tokenizer is not None:
                    out["text"] = self.tokenizer([m["caption"]])[0]
                return out
            except Exception as e:
                last_err = e
                idx = int(self.rng.integers(len(self.metadata)))
                m = self.metadata[idx]
        raise RuntimeError(f"video decode failed after retries: {last_err}")
