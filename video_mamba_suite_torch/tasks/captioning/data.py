"""Dense-captioning data (the port's own copy of the JAX package's
``tasks/captioning/data.py``): the ActivityNet-Captions annotation json
{vid: {"duration": s, "timestamps": [[s, e], ...], "sentences": [...]}}
with one feature file a video ({vid}.npy, (T, C)), captions tokenized
by a word vocabulary built from the json's sentences, events as (center,
length) over the duration; and the collation of a batch for
``CaptioningTrainer.train_step``. Host numpy."""

from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np

from ...data.tokenizer import WordTokenizer


def load_activitynet_captions(
    annotation_json: str,
    feature_dir: str,
    max_events: int = 10,
    max_caption_len: int = 20,
    max_seq_len: Optional[int] = None,
    tokenizer: Optional[WordTokenizer] = None,
    file_ext: str = ".npy",
):
    """→ (items, tokenizer). Each item: feats (T, C) fp32, cut to
    ``max_seq_len`` evenly spaced rows when longer; gt_boxes (G, 2)
    (center, length) / duration; gt_labels (G,); gt_valid (G,); captions
    (G, max_caption_len): BOS (1), the words, EOS (2), then -100; and
    gt_events, the raw events for the metrics. Videos without a feature
    file are skipped; events past ``max_events`` dropped."""
    with open(annotation_json) as f:
        db = json.load(f)
    if tokenizer is None:
        corpus = [s for v in db.values() for s in v.get("sentences", [])]
        tokenizer = WordTokenizer(corpus=corpus,
                                  context_length=max_caption_len)
    items = []
    for vid, meta in db.items():
        path = os.path.join(feature_dir, vid + file_ext)
        if not os.path.exists(path):
            continue
        feats = np.load(path).astype(np.float32)
        if max_seq_len and feats.shape[0] > max_seq_len:
            idx = np.linspace(0, feats.shape[0] - 1, max_seq_len).astype(int)
            feats = feats[idx]
        duration = float(meta["duration"])
        G = max_events
        gt_boxes = np.zeros((G, 2), np.float32)
        gt_labels = np.zeros((G,), np.int32)
        gt_valid = np.zeros((G,), bool)
        captions = np.full((G, max_caption_len), -100, np.int64)
        gt_events = []
        for g, ((s, e), sent) in enumerate(
                zip(meta["timestamps"], meta["sentences"])):
            if g >= G:
                break
            s, e = float(s), float(e)
            gt_boxes[g] = [(s + e) / 2 / duration, (e - s) / duration]
            gt_valid[g] = True
            toks = [tokenizer.BOS] + tokenizer.encode(sent)
            toks = toks[: max_caption_len - 1] + [tokenizer.EOS]
            captions[g, : len(toks)] = toks
            gt_events.append(dict(timestamp=[s, e], sentence=sent.strip()))
        items.append(dict(
            video_id=vid, feats=feats, duration=duration,
            gt_boxes=gt_boxes, gt_labels=gt_labels, gt_valid=gt_valid,
            captions=captions, gt_events=gt_events,
        ))
    return items, tokenizer


def collate_captioning(items: List[dict], max_seq_len: int):
    """Pad and stack a batch: (feats (B, max_seq_len, C), mask (B,
    max_seq_len) 1 at valid steps, gt_boxes, gt_labels, gt_valid,
    captions), numpy."""
    B = len(items)
    C = items[0]["feats"].shape[-1]
    feats = np.zeros((B, max_seq_len, C), np.float32)
    mask = np.zeros((B, max_seq_len), np.float32)
    gt_boxes = np.stack([it["gt_boxes"] for it in items])
    gt_labels = np.stack([it["gt_labels"] for it in items])
    gt_valid = np.stack([it["gt_valid"] for it in items])
    captions = np.stack([it["captions"] for it in items])
    for i, it in enumerate(items):
        t = min(len(it["feats"]), max_seq_len)
        feats[i, :t] = it["feats"][:t]
        mask[i, :t] = 1.0
    return feats, mask, gt_boxes, gt_labels, gt_valid, captions


def vocab_list(tokenizer: WordTokenizer) -> List[str]:
    """id → word, for decoding predictions (``predict(vocab=...)``)."""
    inv = {v: k for k, v in tokenizer.word_to_id.items()}
    return [
        {0: "<pad>", 1: "<bos>", 2: "<eos>", 3: "<unk>"}.get(i, inv.get(i, ""))
        for i in range(tokenizer.vocab_size)
    ]
