"""Checkpoint on preemption (the port's copy of the JAX package's
``utils/preemption.py``).

Schedulers (SLURM, cloud maintenance events) send SIGTERM ahead of
preemption; the reference's recovery is to resume from the last epoch's
checkpoint. A ``PreemptionWatcher`` latches the signal instead of dying,
so a trainer's loop can write the current step and stop cleanly:

    with PreemptionWatcher() as watcher:
        for step, batch in enumerate(loader):
            trainer.train_step(batch)
            if watcher.save_if_needed(trainer.core, ckpt_dir, step,
                                      trainer.state_dict(), every=500):
                break                    # preempted: saved, exit clean

The next run resumes through ``TrainerCore.restore``'s newest step.
"""

from __future__ import annotations

import signal
import threading
from typing import Any, Iterable, Optional


class PreemptionWatcher:
    """Latches termination signals (default SIGTERM) in a flag instead of
    ending the process. The previous handlers come back on ``close()``.
    Outside the main thread no handler can be installed: the watcher
    then never latches, and its loop runs to its end."""

    def __init__(self, signals: Iterable[int] = (signal.SIGTERM,)):
        self._flag = threading.Event()
        self._prev = {}
        for sig in signals:
            try:
                self._prev[sig] = signal.signal(sig, self._handler)
            except (ValueError, OSError):  # non-main thread / unsupported
                pass

    def _handler(self, signum, frame):
        self._flag.set()

    @property
    def preempted(self) -> bool:
        return self._flag.is_set()

    def save_if_needed(self, core: Any, directory: str, step: int,
                       state: Any, every: Optional[int] = None) -> bool:
        """Save on the periodic schedule (``step % every == 0``) or on a
        latched signal. Returns True when preempted: the current step is
        then on disk (the save is synchronous) and the caller can stop."""
        periodic = every is not None and every > 0 and step % every == 0
        if self.preempted or periodic:
            core.save(directory, step, state)
        return self.preempted

    def close(self) -> None:
        """Restore the previous signal handlers."""
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):
                pass
        self._prev.clear()

    def __enter__(self) -> "PreemptionWatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
