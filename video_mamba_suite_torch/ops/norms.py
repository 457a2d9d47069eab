"""LayerNorm and RMSNorm with a fused residual add, prenorm semantics
(counterparts of the JAX package's ``ops/norms.py``: ``layer_norm``,
``rms_norm`` and ``fused_add_norm``). Plain torch ops: the JAX package has
no kernel here either.

Statistics and the affine are computed in fp32 and the result is cast
back to the input's dtype; the prenorm residual is carried in fp32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def layer_norm(x: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor] = None,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps) * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             bias: Optional[torch.Tensor] = None,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last axis."""
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(ms + eps) * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def fused_add_norm(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None,
    prenorm: bool = True,
    residual_in_fp32: bool = True,
    eps: float = 1e-5,
    is_rms_norm: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(residual add) → norm: returns (normed, new_residual) with
    new_residual = x + residual (in fp32 if ``residual_in_fp32``) and
    normed = Norm(new_residual) in x's dtype; new_residual is None unless
    ``prenorm``."""
    res = x.float()
    if residual is not None:
        res = res + residual.float()
    norm = rms_norm if is_rms_norm else layer_norm
    normed = norm(res, weight, bias, eps=eps).to(x.dtype)
    if not prenorm:
        return normed, None
    return normed, res if residual_in_fp32 else res.to(x.dtype)
