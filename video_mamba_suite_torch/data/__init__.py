"""Data layer of the PyTorch port: tokenizers, the video decode pipeline,
feature readers and the prefetch loader (the JAX package's ``data``
exports, but ``ShardedSampler``, whose multi-process half waits for the
parallel layer). Each name imports its module on first use."""

import importlib

_EXPORTS = {
    "SimpleTokenizer": "tokenizer",
    "WordTokenizer": "tokenizer",
    "tokenize": "tokenizer",
    "whitespace_clean": "tokenizer",
    "VideoDecoder": "video",
    "sample_frame_indices": "video",
    "preprocess_clip": "video",
    "CLIP_MEAN": "video",
    "CLIP_STD": "video",
    "FeatureReader": "features",
    "PrefetchLoader": "features",
    "sharded_epoch_order": "sampler",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__),
                   name)
