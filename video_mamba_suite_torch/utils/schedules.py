"""Learning-rate schedules (the port's copy of the JAX package's
``utils/schedules.py``): warmup + cosine, multistep, linear and constant
as functions of the step count with the values of optax's schedules, a
``torch.optim.lr_scheduler.LambdaLR`` that applies one, and the host-side
``ReduceLROnPlateau``.

Two optax conventions carry over. ``warmup_cosine_decay_schedule``'s
``decay_steps`` counts the warmup too. And optax's first update reads the
schedule at count 0, which is 0 with a warmup: the first step moves no
parameter, only the optimizer's moments. ``lambda_lr`` keeps that: the
optimizer's step k (from 0) runs at ``schedule(k)``.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch

Schedule = Callable[[int], float]


def _linear(init: float, end: float, steps: int) -> Schedule:
    """optax.linear_schedule: init to end over ``steps``, then end; a
    constant init when steps <= 0."""
    if steps <= 0:
        return lambda count: init

    def sched(count):
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end
    return sched


def _cosine(init: float, steps: int, alpha: float) -> Schedule:
    """optax.cosine_decay_schedule (exponent 1)."""
    if not steps > 0:
        raise ValueError(f"the cosine decay needs positive decay steps, got "
                         f"{steps}")

    def sched(count):
        cos = 0.5 * (1.0 + math.cos(math.pi * min(count, steps) / steps))
        return init * ((1.0 - alpha) * cos + alpha)
    return sched


def _join(first: Schedule, second: Schedule, boundary: int) -> Schedule:
    """optax.join_schedules: ``second`` counts from ``boundary``."""
    return lambda count: (first(count) if count < boundary
                          else second(count - boundary))


def _piecewise(init: float, boundaries: dict) -> Schedule:
    """optax.piecewise_constant_schedule: scaled from each boundary on."""
    def sched(count):
        v = init
        for threshold, scale in sorted(boundaries.items()):
            if count >= threshold:
                v *= scale
        return v
    return sched


def make_schedule(
    name: str,
    base_lr: float,
    total_steps: int,
    warmup_steps: int = 0,
    min_lr: float = 0.0,
    milestones: Optional[Sequence[int]] = None,
    gamma: float = 0.1,
) -> Schedule:
    """The learning rate as a function of the optimizer's step count, as the
    JAX ``make_schedule`` builds it from optax:

      cosine     linear warmup from 0 (from base_lr without warmup), then
                 cosine decay to min_lr; ``total_steps`` includes the warmup
      multistep  base_lr times gamma at each milestone, counted after the
                 warmup; linear warmup first
      linear     base_lr to min_lr over total_steps after the warmup
      constant   base_lr after the warmup
    """
    if name == "cosine":
        warm = max(warmup_steps, 1) if warmup_steps else 0
        alpha = 0.0 if base_lr == 0.0 else min_lr / base_lr
        return _join(_linear(0.0 if warmup_steps else base_lr, base_lr, warm),
                     _cosine(base_lr, max(total_steps, 1) - warm, alpha),
                     warm)
    if name == "multistep":
        sched = _piecewise(base_lr, {int(m): gamma
                                     for m in (milestones or [])})
    elif name == "linear":
        sched = _linear(base_lr, min_lr, max(total_steps, 1))
    elif name == "constant":
        sched = lambda count: base_lr  # noqa: E731
    else:
        raise ValueError(f"unknown schedule {name!r}")
    if warmup_steps:
        return _join(_linear(0.0, base_lr, warmup_steps), sched,
                     warmup_steps)
    return sched


def lambda_lr(optimizer: torch.optim.Optimizer, schedule: Schedule
              ) -> torch.optim.lr_scheduler.LambdaLR:
    """A LambdaLR that sets every group's learning rate to
    ``schedule(step)`` for the optimizer's step ``step`` (counted from 0):
    each group's ``initial_lr`` becomes 1 and the schedule is the factor.
    Call its ``step()`` after each ``optimizer.step()``."""
    for group in optimizer.param_groups:
        group["initial_lr"] = 1.0
    return torch.optim.lr_scheduler.LambdaLR(optimizer, schedule,
                                             last_epoch=-1)


class ReduceLROnPlateau:
    """Host-side plateau scheduler (the JAX package's): multiply a scale by
    ``factor`` after more than ``patience`` epochs without improvement."""

    def __init__(self, factor: float = 0.5, patience: int = 3,
                 mode: str = "min"):
        self.factor = factor
        self.patience = patience
        self.mode = mode
        self.best = None
        self.bad_epochs = 0
        self.scale = 1.0

    def step(self, metric: float) -> float:
        improved = (self.best is None
                    or (metric < self.best if self.mode == "min"
                        else metric > self.best))
        if improved:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.scale *= self.factor
                self.bad_epochs = 0
        return self.scale
