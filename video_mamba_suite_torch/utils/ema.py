"""Exponential moving average of a model's parameters (the port's copy of
the JAX package's ``utils/ema.py``): fp32 copies, updated after each
optimizer step as e · decay + p · (1 − decay)."""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn


class ModelEma:
    """fp32 EMA of ``model``'s parameters, keyed by parameter name. Starts
    as a copy of the parameters (the JAX ``ema_init``)."""

    def __init__(self, model: nn.Module, decay: float = 0.999):
        self.decay = decay
        self.names = [n for n, _ in model.named_parameters()]
        self.params = [p.detach().float().clone()
                       for _, p in model.named_parameters()]

    @torch.no_grad()
    def update(self, model: nn.Module) -> None:
        """e ← e · decay + p · (1 − decay) for every parameter (the JAX
        ``ema_update``), in place."""
        new = [p.detach().float() for _, p in model.named_parameters()]
        torch._foreach_mul_(self.params, self.decay)
        torch._foreach_add_(self.params, new, alpha=1.0 - self.decay)

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return dict(zip(self.names, self.params))

    def load_state_dict(self, state: Dict[str, torch.Tensor]) -> None:
        if set(state) != set(self.names):
            raise KeyError(f"EMA state names differ: missing "
                           f"{sorted(set(self.names) - set(state))}, "
                           f"unexpected {sorted(set(state) - set(self.names))}")
        with torch.no_grad():
            for e, name in zip(self.params, self.names):
                e.copy_(state[name])

    @torch.no_grad()
    def copy_to(self, model: nn.Module) -> None:
        """Write the averages into ``model``'s parameters."""
        for (_, p), e in zip(model.named_parameters(), self.params):
            p.copy_(e)
