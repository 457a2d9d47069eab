"""Profiling and step timing (the port's counterpart of the JAX package's
``utils/profiling.py``): ``torch.profiler`` traces written as Chrome
traces, a step timer that waits for the card before it reads the clock,
and the card's memory in use. These replace the reference's
``torch.cuda.synchronize`` wall clocks and ``max_memory_allocated``
meters (SURVEY.md §5).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch

from .profiler_window import padded_profile


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator:
    """Profile the body of the ``with`` block (the host, and the card when
    there is one) and write its Chrome trace (viewable in Perfetto or
    chrome://tracing) to ``log_dir/trace-<pid>-<ns>.json``. The window is
    ``padded_profile``'s, so kernels whose card timestamps stray from the
    host's clock by a few milliseconds are kept. Yields the profiler."""
    from torch.profiler import ProfilerActivity

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with padded_profile(activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


def _synchronize(result) -> None:
    """Wait for the device work behind ``result`` (a tensor, or containers
    of them): each CUDA device that holds one of its tensors is
    synchronised."""
    devices = set()

    def visit(x):
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                visit(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                visit(v)

    visit(result)
    for device in devices:
        torch.cuda.synchronize(device)


class StepTimer:
    """Mean step time: ``start()``, the step, ``stop(result)``; ``stop``
    waits for ``result``'s device work before it reads the clock (the
    reference's train_utils.py:299-301 timing)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = None
        self.total = 0.0
        self.count = 0

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, result=None):
        if result is not None:
            _synchronize(result)
        self.total += time.perf_counter() - self._t0
        self.count += 1

    @property
    def avg_ms(self) -> float:
        return 1e3 * self.total / max(self.count, 1)


def live_memory_bytes() -> Optional[int]:
    """Bytes of the card's memory held by tensors
    (``torch.cuda.memory_allocated``), None without a card."""
    if not torch.cuda.is_available():
        return None
    return int(torch.cuda.memory_allocated())
