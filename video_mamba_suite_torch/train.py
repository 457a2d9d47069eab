"""One training step of a video encoder (the port's counterpart of the
train step in the JAX package's ``bench.py``: the MSE of the fp32 output
against a target, its gradient, one optimizer update).

    model = build_timemamba_b()                       # on the card, bf16
    opt = make_optimizer(model, "adamw", lr=1e-4, weight_decay=1e-4)
    loss = train_step(model, opt, x, y)

On the card the Mamba mixers' scans run K1 forward and K2 backward.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


def train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
               x: torch.Tensor, y: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """mean((model(x) - y)²) in fp32, backward, one optimizer step. Puts
    the model in training mode; ``generator`` draws its dropout masks.
    Returns the loss before the step, detached (reading it waits for the
    device)."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    out = model(x, generator=generator).float()
    loss = torch.mean((out - y) ** 2)
    loss.backward()
    optimizer.step()
    return loss.detach()
