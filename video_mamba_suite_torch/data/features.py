"""Pre-extracted feature readers and a threaded host-to-device prefetch (the
port's own copy of the JAX package's ``data/features.py``).

``FeatureReader`` reads one video's features from ``.npy`` (memory-mapped),
``.npz`` (``["features"]``) or ``.pt`` files. ``PrefetchLoader`` builds
batches on worker threads and hands them over in order, moved to the
device from pinned memory, so that host IO and collation overlap the
device's work. An exception in a worker reaches the consumer.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Any, Callable, Iterator

import numpy as np
import torch


class FeatureReader:
    """Features of ``root/<video_id><ext>``: ``.npy`` (memory-mapped when
    ``mmap``), ``.npz`` (its ``features`` array) or ``.pt`` (zip or legacy
    format, through ``pt_reader.load_pt``; bfloat16 widened to float32).
    The first ``cache_size`` videos read stay cached."""

    def __init__(self, root: str, ext: str = ".npy", mmap: bool = True,
                 cache_size: int = 0):
        self.root = root
        self.ext = ext
        self.mmap = mmap
        self._cache: dict = {}
        self.cache_size = cache_size

    def __call__(self, video_id: str) -> np.ndarray:
        if video_id in self._cache:
            return self._cache[video_id]
        path = os.path.join(self.root, video_id + self.ext)
        if self.ext == ".npy":
            arr = np.load(path, mmap_mode="r" if self.mmap else None)
        elif self.ext == ".npz":
            arr = np.load(path)["features"]
        elif self.ext == ".pt":
            from .pt_reader import load_pt

            arr = np.asarray(load_pt(path))
        else:
            raise ValueError(f"unknown feature ext {self.ext!r}")
        if self.cache_size and len(self._cache) < self.cache_size:
            self._cache[video_id] = arr
        return arr


def _to_device(batch, device: torch.device):
    """``batch`` with every numpy array and tensor moved to ``device``
    (through pinned memory and a non-blocking copy on a card), through
    dicts, lists and tuples; other leaves as they are."""
    if isinstance(batch, (np.ndarray, torch.Tensor)):
        t = torch.as_tensor(batch)
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)
    if isinstance(batch, dict):
        return type(batch)((k, _to_device(v, device))
                           for k, v in batch.items())
    if isinstance(batch, (list, tuple)):
        return type(batch)(_to_device(v, device) for v in batch)
    return batch


class PrefetchLoader:
    """``num_batches`` batches ``batch_fn(0), batch_fn(1), ...`` built on
    ``num_workers`` threads and yielded in order, each moved to ``device``
    (the card unless the caller asks for "cpu"; left on the host without
    ``device_put``). At most ``num_workers + 1`` batches wait. Where
    ``batch_fn`` raises, the iteration raises that exception (the JAX
    loader waits for ever there). ``sharding`` is the data-parallel
    layout, which is not ported yet."""

    def __init__(self, batch_fn: Callable[[int], Any], num_batches: int,
                 num_workers: int = 2, device_put: bool = True,
                 sharding=None, device="cuda"):
        if sharding is not None:
            raise NotImplementedError(
                "a sharded PrefetchLoader (sharding) waits for the port's "
                "parallel layer (ROADMAP queue 1 item 10)")
        from ..models.common import resolve_device

        self.batch_fn = batch_fn
        self.num_batches = num_batches
        self.num_workers = max(1, num_workers)
        self.device_put = device_put
        self.device = resolve_device(device) if device_put else None

    def _put(self, batch):
        if not self.device_put:
            return batch
        return _to_device(batch, self.device)

    def __iter__(self) -> Iterator[Any]:
        q: "queue.Queue" = queue.Queue(maxsize=self.num_workers + 1)
        indices = iter(range(self.num_batches))
        lock = threading.Lock()
        stop = threading.Event()
        done = object()

        def put(item) -> bool:
            """Queue ``item`` unless the consumer has stopped."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            while not stop.is_set():
                with lock:
                    i = next(indices, None)
                if i is None:
                    break
                try:
                    item = (i, self.batch_fn(i))
                except BaseException as e:    # handed to the consumer
                    put(e)
                    return
                if not put(item):
                    return
            put(done)

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        buf = {}
        next_idx = finished = 0
        try:
            while next_idx < self.num_batches and finished < self.num_workers:
                item = q.get()
                if item is done:
                    finished += 1
                    continue
                if isinstance(item, BaseException):
                    raise item
                i, batch = item
                buf[i] = batch
                while next_idx in buf:
                    yield self._put(buf.pop(next_idx))
                    next_idx += 1
            while next_idx in buf:
                yield self._put(buf.pop(next_idx))
                next_idx += 1
        finally:
            stop.set()
            for t in threads:
                t.join()
