"""Rotary position embedding over the sequence axis (the port's
counterpart of the JAX package's ``models/rope.py``): the ``if_rope``
option of UniVTG-Mamba. Plain torch: the JAX package has no kernel here.
"""

from __future__ import annotations

import torch


def rope_rotate(x: torch.Tensor, base: float = 10000.0) -> torch.Tensor:
    """x (B, L, D), D even: the first and second halves of the channels
    rotated as pairs by the angle position × base^(-i / (D/2)), computed
    in fp32 and cast back to x's dtype."""
    _, L, D = x.shape
    half = D // 2
    freqs = base ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    angles = torch.arange(L, dtype=torch.float32,
                          device=x.device)[:, None] * freqs[None]
    cos, sin = torch.cos(angles)[None], torch.sin(angles)[None]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
