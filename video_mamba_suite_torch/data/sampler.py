"""The sample order of an epoch (the port's copy of the JAX package's
``data/sampler.py`` ``sharded_epoch_order``, for one process: the
multi-process shards come with the port's parallel layer)."""

from __future__ import annotations

import numpy as np


def sharded_epoch_order(n: int, epoch: int, seed: int = 0) -> list:
    """The order in which one process walks ``n`` samples in ``epoch``: a
    permutation seeded by ``seed + epoch``, as ``DistributedSampler``
    shuffles with one shard."""
    return [int(i) for i in
            np.random.default_rng(seed + epoch).permutation(n)]
