"""Mixup / CutMix and label smoothing for video classification (the
port's copy of the JAX package's ``tasks/recognition/augment.py``).

The JAX ``mixup_cutmix`` draws its random numbers and applies them in one
function. Here the two are apart: ``draw_mixup_cutmix`` takes them from a
``torch.Generator`` and ``apply_mixup_cutmix`` is deterministic, so a test
can feed the JAX draw to the port's apply. The semantics are the JAX
package's (timm's Mixup at the batch level): the batch is paired with its
reverse, one box is shared by the whole batch, λ is corrected to the box's
area, and ``switch_prob`` picks cutmix over mixup.

One quirk of the JAX draw is kept: the box centre's row and column come
from the same key, so ``cy == cx`` whenever H == W.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def one_hot_smooth(labels: torch.Tensor, num_classes: int,
                   smoothing: float = 0.0) -> torch.Tensor:
    """fp32 one-hot targets with ``smoothing`` spread over all classes."""
    off = smoothing / num_classes
    on = 1.0 - smoothing + off
    return F.one_hot(labels.long(), num_classes).float() * (on - off) + off


class MixDraw(NamedTuple):
    """The random numbers of one ``mixup_cutmix`` call."""
    lam_mix: float      # mixup's λ ~ Beta(mixup_alpha, mixup_alpha)
    lam_cut: float      # cutmix's λ ~ Beta(cutmix_alpha, cutmix_alpha)
    use_cutmix: bool    # uniform < switch_prob
    cy: int             # box centre, row in [0, H)
    cx: int             # box centre, column in [0, W)


def _gamma(alpha: float, generator: torch.Generator) -> float:
    """One Gamma(alpha, 1) sample (Marsaglia and Tsang; alpha < 1 through
    Gamma(alpha + 1) · U^(1/alpha))."""
    def normal():
        return float(torch.randn((), generator=generator))

    def uniform():
        return float(torch.rand((), generator=generator))

    boost = 1.0
    if alpha < 1.0:
        boost = uniform() ** (1.0 / alpha)
        alpha += 1.0
    d = alpha - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    while True:
        x = normal()
        v = (1.0 + c * x) ** 3
        if v <= 0.0:
            continue
        u = uniform()
        if math.log(max(u, 1e-300)) < 0.5 * x * x + d - d * v + d * math.log(v):
            return d * v * boost


def _beta(alpha: float, generator: torch.Generator) -> float:
    """One Beta(alpha, alpha) sample."""
    x = _gamma(alpha, generator)
    y = _gamma(alpha, generator)
    return x / (x + y)


def draw_mixup_cutmix(generator: torch.Generator, height: int, width: int,
                      mixup_alpha: float = 0.8, cutmix_alpha: float = 1.0,
                      switch_prob: float = 0.5) -> MixDraw:
    """The draw of the JAX ``mixup_cutmix`` from a CPU ``generator``.
    Both alphas must be positive: with one at 0 the JAX draw gives NaN."""
    if mixup_alpha <= 0 or cutmix_alpha <= 0:
        raise ValueError(f"mixup_cutmix needs both alphas > 0, got "
                         f"{mixup_alpha} and {cutmix_alpha}")
    lam_mix = _beta(mixup_alpha, generator)
    lam_cut = _beta(cutmix_alpha, generator)
    use_cutmix = float(torch.rand((), generator=generator)) < switch_prob
    key = int(torch.randint(2 ** 62, (), generator=generator))
    # one key for both coordinates, as the JAX draw (augment.py:51-52)
    cy = int(torch.randint(height, (),
                           generator=torch.Generator().manual_seed(key)))
    cx = int(torch.randint(width, (),
                           generator=torch.Generator().manual_seed(key)))
    return MixDraw(lam_mix, lam_cut, use_cutmix, cy, cx)


def apply_mixup_cutmix(videos: torch.Tensor, labels: torch.Tensor,
                       num_classes: int, draw: MixDraw,
                       smoothing: float = 0.1
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mix ``videos`` (B, T, H, W, C) with their reversed batch by the
    numbers of ``draw``; returns (mixed videos, fp32 soft targets)."""
    H, W = videos.shape[2], videos.shape[3]
    flipped = videos.flip(0)
    y1 = one_hot_smooth(labels, num_classes, smoothing)
    y2 = y1.flip(0)
    if draw.use_cutmix:
        # the box in fp32 and int32 arithmetic, as the JAX code
        cut_rat = np.sqrt(np.float32(1.0) - np.float32(draw.lam_cut))
        ch = int(cut_rat * np.float32(H))
        cw = int(cut_rat * np.float32(W))
        y0, y1b = (min(max(draw.cy + s * (ch // 2), 0), H) for s in (-1, 1))
        x0, x1b = (min(max(draw.cx + s * (cw // 2), 0), W) for s in (-1, 1))
        mixed = videos.clone()
        mixed[:, :, y0:y1b, x0:x1b] = flipped[:, :, y0:y1b, x0:x1b]
        lam = float(np.float32(1.0) - np.float32((y1b - y0) * (x1b - x0))
                    / np.float32(H * W))
    else:
        lam = float(np.float32(draw.lam_mix))
        mixed = videos * lam + flipped * float(np.float32(1.0) -
                                               np.float32(lam))
    targets = y1 * lam + y2 * float(np.float32(1.0) - np.float32(lam))
    return mixed, targets


def mixup_cutmix(generator: torch.Generator, videos: torch.Tensor,
                 labels: torch.Tensor, num_classes: int,
                 mixup_alpha: float = 0.8, cutmix_alpha: float = 1.0,
                 switch_prob: float = 0.5, smoothing: float = 0.1
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batch-level mixup or cutmix (the JAX ``mixup_cutmix``): a draw from
    ``generator``, then ``apply_mixup_cutmix``."""
    draw = draw_mixup_cutmix(generator, videos.shape[2], videos.shape[3],
                             mixup_alpha, cutmix_alpha, switch_prob)
    return apply_mixup_cutmix(videos, labels, num_classes, draw, smoothing)
