"""Running averages of training values (the port's copy of the JAX
package's ``utils/meters.py``; the AverageMeters of every reference
suite: TAL train_utils.py:198-228, avion/utils/meters.py)."""

from __future__ import annotations


class AverageMeter:
    """The last value and the running mean of a value, weighted by ``n``;
    values are kept as Python floats (a 0-d tensor is read once)."""

    def __init__(self, name: str = "", fmt: str = ":f"):
        self.name = name
        self.fmt = fmt
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = float(val)
        self.sum += self.val * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)

    def __str__(self):
        return f"{self.name} {self.val:{self.fmt[1:]}} ({self.avg:{self.fmt[1:]}})"
