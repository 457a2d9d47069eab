"""Metric logging (the port's copy of the JAX package's
``utils/logging.py``): an append-only JSONL stream per run, TensorBoard
scalars where the ``tensorboard`` package is installed, and a line on
stdout. Logged values are Python numbers (or strings), never tensors: a
one-element tensor is read once, a larger one becomes a list."""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

import torch


class MetricLogger:
    def __init__(self, log_dir: Optional[str] = None, name: str = "train",
                 stdout: bool = True):
        self.stdout = stdout
        self._fh = None
        self._tb = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._fh = open(os.path.join(log_dir, f"{name}.jsonl"), "a")
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(os.path.join(log_dir, "tb"))
            except Exception:
                self._tb = None

    def log(self, step: int, metrics: Dict[str, Any], prefix: str = ""):
        values = {k: _to_py(v) for k, v in metrics.items()}
        rec = {"step": step, "time": time.time()}
        rec.update({f"{prefix}{k}": v for k, v in values.items()})
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        if self._tb:
            for k, v in values.items():
                if isinstance(v, (int, float)):
                    self._tb.add_scalar(prefix + k, v, step)
        if self.stdout:
            parts = " ".join(f"{k}={_fmt(v)}" for k, v in values.items())
            print(f"[{prefix or 'step'} {step}] {parts}", flush=True)

    def close(self):
        if self._fh:
            self._fh.close()
        if self._tb:
            self._tb.close()


def _to_py(v):
    """A Python number (float) where ``v`` is one, a list for a larger
    tensor, else ``v``."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        if v.numel() != 1:
            return v.tolist()
        v = v.item()
    try:
        return float(v)
    except (TypeError, ValueError):
        return v


def _fmt(v):
    return f"{v:.4f}" if isinstance(v, float) else str(v)
