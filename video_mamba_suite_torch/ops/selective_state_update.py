"""One decode step of the SSM state, plain PyTorch (counterpart of the JAX
package's ``ops/selective_state_update.py``: ``selective_state_update``).

The JAX package has no kernel here (XLA fuses the expression), so the port
owes none: these are plain torch ops.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def selective_state_update(
    state: torch.Tensor,
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    D: Optional[torch.Tensor] = None,
    z: Optional[torch.Tensor] = None,
    dt_bias: Optional[torch.Tensor] = None,
    dt_softplus: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Advance the state by one token.

    state (batch, dim, dstate); x, dt, z (batch, dim); A (dim, dstate);
    B, C (batch, dstate); D, dt_bias (dim,). Arithmetic is fp32:

        dt' = softplus(dt + dt_bias)                  (softplus optional)
        h   = exp(dt' * A) * state + dt' * B * x
        y   = (sum_n C * h + D * x) * silu(z)

    Returns (y in x's dtype, h in state's dtype).
    """
    xf = x.float()
    dtf = dt.float()
    if dt_bias is not None:
        dtf = dtf + dt_bias.float()
    if dt_softplus:
        dtf = F.softplus(dtf)
    dtf = dtf[..., None]                                   # (b, d, 1)
    new_state = (state.float() * torch.exp(dtf * A.float())
                 + xf[..., None] * (dtf * B.float()[:, None, :]))
    y = torch.einsum("bdn,bn->bd", new_state, C.float())
    if D is not None:
        y = y + D.float() * xf
    if z is not None:
        y = y * F.silu(z.float())
    return y.to(x.dtype), new_state.to(state.dtype)
