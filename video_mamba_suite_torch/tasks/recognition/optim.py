"""Layer-wise decay for ViT-style fine-tuning (the port's copy of the JAX
package's ``tasks/recognition/optim.py``): each parameter's factor is
decay ** (num_layers + 1 − layer_id).

The JAX rule reads the layer id from flax paths (``_layer_id_from_path``):
the embeddings → 0; ``mixer{i}``, ``norm{i}_*``, ``dp{i}`` → i + 1;
everything else (the final norm, the head) → num_layers + 1. ViViM's
parameters in the port are named ``layers.{i}.…``, which that regex would
not match, so the rule below is written for the port's names and gives
each counterpart parameter the same id.
"""

from __future__ import annotations

import re
from typing import Dict

from torch import nn

_EMBEDDINGS = ("patch_embed", "pos_embed", "cls_token", "temporal_embed")
_LAYER = re.compile(r"^layers\.(\d+)\.")


def layer_id(name: str, num_layers: int) -> int:
    """The layer id of the parameter called ``name``."""
    if any(s in name for s in _EMBEDDINGS):
        return 0
    m = _LAYER.match(name)
    if m:
        return int(m.group(1)) + 1
    return num_layers + 1


def layer_decay_param_groups(model: nn.Module, num_layers: int,
                             decay: float) -> Dict[str, float]:
    """Parameter name → decay ** (num_layers + 1 − layer_id)."""
    return {name: decay ** (num_layers + 1 - layer_id(name, num_layers))
            for name, _ in model.named_parameters()}
