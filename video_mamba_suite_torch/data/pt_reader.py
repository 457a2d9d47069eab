"""Reader of PyTorch ``.pt`` / ``.pth`` files for the feature readers (the
port's counterpart of the JAX package's ``data/pt_reader.py``).

The TAL datasets upstream ship per-video features as ``torch.save``-d
tensors. ``load_pt`` reads one with ``torch.load(path, map_location="cpu",
weights_only=True)``: tensors, parameters and containers of them load, and
a file that names any other global is refused with
``pickle.UnpicklingError``, as the JAX package's restricted unpickler
refuses it. The tensors come back as numpy arrays in the same nesting,
as the JAX reader returns them.
"""

from __future__ import annotations

import zipfile
from typing import Any

import numpy as np
import torch

__all__ = ["load_pt", "is_zip_pt"]


def is_zip_pt(path: str) -> bool:
    """True for the zip format that ``torch.save`` has written since torch
    1.6; False for the legacy format."""
    return zipfile.is_zipfile(path)


def _to_numpy(obj: Any) -> Any:
    """``obj`` with every tensor replaced by a numpy array (owned, on the
    host), through dicts, lists and tuples. numpy has no bfloat16 without
    ``ml_dtypes``, which the card's machine lacks, so a bfloat16 tensor
    comes back widened to float32, exactly (every bfloat16 is a
    float32)."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy().copy()
    if isinstance(obj, dict):
        return type(obj)((k, _to_numpy(v)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_numpy(v) for v in obj)
    return obj


def load_pt(path: str) -> Any:
    """A ``.pt`` file's object with numpy arrays in place of tensors (a
    bfloat16 tensor widened to float32). Only weights load: a file naming
    another global raises ``pickle.UnpicklingError``."""
    return _to_numpy(torch.load(path, map_location="cpu", weights_only=True))
