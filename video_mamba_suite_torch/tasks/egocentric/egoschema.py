"""EgoSchema zero-shot question answering by CLIP similarity (the port's
copy of the JAX package's ``tasks/egocentric/egoschema.py``): encode the
clip, encode each answer option as text, pick the option of highest cosine
similarity; accuracy over the questions."""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import numpy as np


def egoschema_zero_shot(
    encode_video: Callable[[np.ndarray], np.ndarray],
    encode_text: Callable[[np.ndarray], np.ndarray],
    questions: Sequence[Dict],
    tokenizer,
) -> Dict[str, float]:
    """questions: [{video: (T, H, W, 3) array, options: [str x 5], answer:
    int}] → {'accuracy': %}. ``encode_video`` maps (1, T, H, W, 3) to
    (1, D), ``encode_text`` the tokenizer's ids of the options to (5, D)."""
    correct = 0
    for q in questions:
        v = encode_video(q["video"][None])
        v = v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-8)
        t = encode_text(tokenizer(list(q["options"])))
        t = t / np.maximum(np.linalg.norm(t, axis=-1, keepdims=True), 1e-8)
        pred = int(np.argmax(v @ t.T))
        correct += int(pred == int(q["answer"]))
    return {"accuracy": 100.0 * correct / max(len(questions), 1)}
