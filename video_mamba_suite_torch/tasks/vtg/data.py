"""Moment-retrieval data (the port's own copy of the JAX package's
``tasks/vtg/data.py``, host numpy): the per-clip ``timestamp`` grid
(normalized), the nearest relevant window of each clip
(``span_labels_nn``), the in-window indicator (``timestamp_window``, at
least one positive), the saliency positive, static-shape padding to
``max_q_l`` / ``max_v_l``, the QVHighlights jsonl schema, file-backed
features, and synthetic samples with the query planted in its window.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

import numpy as np


def build_targets(
    ctx_l: int,
    relevant_windows: Sequence[Sequence[float]],  # seconds
    clip_len: float,
    saliency_scores: Optional[np.ndarray] = None,
    rng: Optional[np.random.Generator] = None,
) -> Dict[str, np.ndarray]:
    """Targets for one sample (upstream main/dataset.py:179-236)."""
    rng = rng or np.random.default_rng(0)
    ts = ((np.arange(ctx_l) + clip_len / 2) / ctx_l)
    timestamp = np.stack([ts, ts], axis=1).astype(np.float32)  # (L, 2)

    windows = np.asarray(relevant_windows, np.float64).reshape(-1, 2)
    windows_ts = windows / (ctx_l * clip_len)

    nn_window = np.zeros_like(timestamp)
    diff_left = timestamp[:, None, 0] - windows_ts[None, :, 0]
    diff_right = windows_ts[None, :, 1] - timestamp[:, None, 1]
    inside = (diff_left >= 0) & (diff_right >= 0)     # (L, W)
    rows, cols = np.nonzero(inside)
    if rows.size == 0:
        nn_window = np.tile(windows_ts[0], (ctx_l, 1)).astype(np.float32)
    else:
        nn_window[rows] = windows_ts[cols]

    window_ind = (
        (timestamp[:, 0] >= nn_window[:, 0])
        & (timestamp[:, 1] <= nn_window[:, 1])
    ).astype(np.float32)
    if window_ind.sum() < 1:  # force one positive (dataset.py:207-210)
        idx = int(np.clip(windows[0, 0] / clip_len, 0, ctx_l - 1))
        window_ind[idx] = 1.0

    if saliency_scores is None:
        saliency_scores = window_ind.copy()
    pos_candidates = np.nonzero(window_ind)[0]
    pos = int(rng.choice(pos_candidates)) if pos_candidates.size else 0

    return dict(
        timestamp=timestamp,
        timestamp_window=window_ind.astype(np.float32),
        span_labels_nn=nn_window.astype(np.float32),
        saliency_scores=np.asarray(saliency_scores, np.float32),
        saliency_pos_labels=np.int32(pos),
    )


def collate_vtg(samples: List[Dict], max_q_l: int, max_v_l: int) -> Dict:
    """Pad a list of samples (each with txt_feat (Lt, Dt), vid_feat (Lv, Dv),
    targets) into static-shape arrays."""
    B = len(samples)
    Dt = samples[0]["txt_feat"].shape[-1]
    Dv = samples[0]["vid_feat"].shape[-1]
    out = dict(
        src_txt=np.zeros((B, max_q_l, Dt), np.float32),
        src_txt_mask=np.zeros((B, max_q_l), np.float32),
        src_vid=np.zeros((B, max_v_l, Dv), np.float32),
        src_vid_mask=np.zeros((B, max_v_l), np.float32),
        timestamp=np.zeros((B, max_v_l, 2), np.float32),
        timestamp_mask=np.zeros((B, max_v_l), np.float32),
        timestamp_window=np.zeros((B, max_v_l), np.float32),
        span_labels_nn=np.zeros((B, max_v_l, 2), np.float32),
        saliency_scores=np.zeros((B, max_v_l), np.float32),
        saliency_pos_labels=np.zeros((B,), np.int32),
    )
    for i, s in enumerate(samples):
        lt = min(len(s["txt_feat"]), max_q_l)
        lv = min(len(s["vid_feat"]), max_v_l)
        out["src_txt"][i, :lt] = s["txt_feat"][:lt]
        out["src_txt_mask"][i, :lt] = 1
        out["src_vid"][i, :lv] = s["vid_feat"][:lv]
        out["src_vid_mask"][i, :lv] = 1
        t = s["targets"]
        out["timestamp"][i, :lv] = t["timestamp"][:lv]
        out["timestamp_mask"][i, :lv] = 1
        out["timestamp_window"][i, :lv] = t["timestamp_window"][:lv]
        out["span_labels_nn"][i, :lv] = t["span_labels_nn"][:lv]
        out["saliency_scores"][i, :lv] = t["saliency_scores"][:lv]
        out["saliency_pos_labels"][i] = t["saliency_pos_labels"]
    return out


def load_jsonl_dataset(data_path: str) -> List[dict]:
    """QVHighlights-style jsonl, one dict a line (upstream DatasetMR
    schema, main/dataset.py:412-420)."""
    with open(data_path) as f:
        return [json.loads(l) for l in f if l.strip()]


def load_file_dataset(
    jsonl_path: str,
    v_feat_dirs: Sequence[str],
    q_feat_dir: str,
    clip_len: float = 2.0,
    max_v_l: int = 75,
    seed: int = 0,
) -> List[Dict]:
    """File-backed MR dataset (DatasetMR :410-520 semantics): per line, load
    video features from each v_feat_dir ({vid}.npy, channel-concatenated —
    the SlowFast+CLIP stacking), query features from q_feat_dir
    ({qid}.npy), and build the MR targets from relevant_windows."""
    import os

    if isinstance(v_feat_dirs, str):
        v_feat_dirs = [v_feat_dirs]
    rng = np.random.default_rng(seed)
    samples = []
    for meta in load_jsonl_dataset(jsonl_path):
        feats = []
        for d in v_feat_dirs:
            f = np.load(os.path.join(d, f"{meta['vid']}.npy"))
            feats.append(f.astype(np.float32))
        n = min(min(f.shape[0] for f in feats), max_v_l)
        vid_feat = np.concatenate([f[:n] for f in feats], axis=-1)
        txt_feat = np.load(
            os.path.join(q_feat_dir, f"{meta['qid']}.npy")
        ).astype(np.float32)
        if txt_feat.ndim == 1:
            txt_feat = txt_feat[None]
        windows = meta.get("relevant_windows", [[0, n * clip_len]])
        sal = None
        if "saliency_scores" in meta and "relevant_clip_ids" in meta:
            sal = np.zeros(n, np.float32)
            for cid, sc in zip(meta["relevant_clip_ids"],
                               meta["saliency_scores"]):
                if cid < n:
                    sal[cid] = float(np.mean(sc))
        targets = build_targets(n, windows, clip_len,
                                saliency_scores=sal, rng=rng)
        samples.append(dict(
            qid=meta["qid"], vid=meta["vid"], txt_feat=txt_feat,
            vid_feat=vid_feat, targets=targets, relevant_windows=windows,
            duration=meta.get("duration", n * clip_len), clip_len=clip_len,
        ))
    return samples


def make_synthetic_vtg(
    num_samples: int = 8, ctx_l: int = 48, txt_len: int = 6,
    txt_dim: int = 16, vid_dim: int = 16, clip_len: float = 2.0, seed: int = 0,
) -> List[Dict]:
    """Grounding data with learnable structure: the query vector is planted
    inside the relevant window of the video features."""
    rng = np.random.default_rng(seed)
    samples = []
    for i in range(num_samples):
        q_vec = rng.standard_normal(txt_dim) * 2.0
        txt = 0.2 * rng.standard_normal((txt_len, txt_dim)) + q_vec[None]
        vid = 0.3 * rng.standard_normal((ctx_l, vid_dim))
        start = int(rng.integers(0, ctx_l - 12))
        end = start + int(rng.integers(6, 12))
        vid[start:end, : min(txt_dim, vid_dim)] += q_vec[: min(txt_dim, vid_dim)][None]
        windows = [[start * clip_len, end * clip_len]]
        targets = build_targets(ctx_l, windows, clip_len, rng=rng)
        samples.append(dict(
            qid=i, txt_feat=txt.astype(np.float32),
            vid_feat=vid.astype(np.float32), targets=targets,
            relevant_windows=windows, duration=ctx_l * clip_len,
            clip_len=clip_len,
        ))
    return samples
