"""Depthwise causal 1-D convolution with optional SiLU, plain PyTorch
(counterparts of the JAX package's ``ops/causal_conv1d.py``:
``causal_conv1d_ref`` and the one-token decode update
``causal_conv1d_update``).

Layout is time-major: x is (batch, seqlen, dim) and the taps are
(width, dim), as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def causal_conv1d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    activation: Optional[str] = None,
    reverse: bool = False,
) -> torch.Tensor:
    """out[t] = sum_k weight[k] * x[t - (W-1) + k], zero-padded on the left.

    reverse=True is the anti-causal direction, flip(conv(flip(x))): the input
    is padded on the right and the taps run backwards. The sum is computed
    in the promoted type of x and weight and cast back to x's dtype.
    """
    if activation not in (None, "silu", "swish"):
        raise ValueError(f"unsupported activation {activation!r}")
    width = weight.shape[0]
    seqlen = x.shape[1]
    pad = (0, 0, 0, width - 1) if reverse else (0, 0, width - 1, 0)
    padded = F.pad(x, pad)
    compute = torch.promote_types(x.dtype, weight.dtype)
    out = torch.zeros(x.shape, dtype=compute, device=x.device)
    for k in range(width):
        tap = weight[width - 1 - k] if reverse else weight[k]
        out = out + padded[:, k:k + seqlen, :] * tap
    if bias is not None:
        out = out + bias
    if activation is not None:
        out = F.silu(out)
    return out.to(x.dtype)


def causal_conv1d_update(
    x: torch.Tensor,
    conv_state: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    activation: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode token through the rolling conv window.

    x (batch, dim) is the new token's channels; conv_state (batch, width,
    dim) the window, oldest first; weight (width, dim). The window rolls
    left and takes x last: new_state = [conv_state[:, 1:], x], in the
    promoted type of both (fp32 for the LM's fp32 states). Returns
    (out (batch, dim) in x's dtype, new_state), out = act(sum_k
    new_state[:, k] * weight[k] + bias), summed in the promoted type of
    new_state and weight.
    """
    if activation not in (None, "silu", "swish"):
        raise ValueError(f"unsupported activation {activation!r}")
    dtype = torch.promote_types(conv_state.dtype, x.dtype)
    new_state = torch.cat([conv_state[:, 1:].to(dtype),
                           x[:, None].to(dtype)], dim=1)
    out = (new_state * weight).sum(dim=1)
    if bias is not None:
        out = out + bias
    if activation is not None:
        out = F.silu(out)
    return out.to(x.dtype), new_state
