"""Checkpoints of a trainer's whole state (the port's counterpart of the
JAX package's orbax ``utils/checkpoint.py``), written with ``torch.save``.

A checkpoint directory holds one subdirectory per integer step,
``<directory>/<step>/state.pt``. A save writes a temporary subdirectory
(a name that is not an integer) and renames it into place, so a save that
is killed leaves no step behind; only the ``max_to_keep`` newest steps
stay. A restore loads with ``weights_only=True``: a state of tensors,
numbers, strings, ``None`` and containers of them loads, anything else
fails loudly.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Any, List, Optional

import torch

STATE_FILE = "state.pt"


def _steps(directory: str) -> List[int]:
    """The complete steps under ``directory``, in ascending order."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(name) for name in os.listdir(directory)
                  if name.isdigit()
                  and os.path.isfile(os.path.join(directory, name,
                                                  STATE_FILE)))


def save_checkpoint(directory: str, step: int, state: Any,
                    max_to_keep: int = 3) -> None:
    """Write ``state`` (e.g. {'params': ..., 'opt_state': ..., 'ema':
    ...}) as step ``step`` of ``directory``, replacing that step if it
    exists, then drop all but the ``max_to_keep`` newest steps."""
    os.makedirs(directory, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f".{int(step)}-", dir=directory)
    try:
        torch.save(state, os.path.join(tmp, STATE_FILE))
        final = os.path.join(directory, str(int(step)))
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    for old in _steps(directory)[:-max_to_keep]:
        shutil.rmtree(os.path.join(directory, str(old)))


def latest_step(directory: str) -> Optional[int]:
    """The newest complete step under ``directory``, or None."""
    steps = _steps(directory)
    return steps[-1] if steps else None


def restore_checkpoint(directory: str, step: Optional[int] = None,
                       map_location=None) -> Any:
    """The state saved as ``step`` (the newest when None) of
    ``directory``, its tensors on ``map_location``; None when the
    directory holds no step."""
    if step is None:
        step = latest_step(directory)
    if step is None:
        return None
    return torch.load(os.path.join(directory, str(int(step)), STATE_FILE),
                      map_location=map_location, weights_only=True)
