"""Mamba mixer body: conv → projections → selective scan → gate
(counterpart of the JAX package's ``ops/mamba_inner.py``: ``mamba_inner``,
one direction at any length, and ``mamba_inner_bidir``, its fused
short-sequence branch).

Projection matrices are in torch's (out_features, in_features) layout.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .causal_conv1d import causal_conv1d
from .selective_scan import selective_scan
from .selective_scan_bidir import selective_scan_bidir

MASKED_DELTA = -1e4  # softplus(-1e4 + bias) == 0 ⇒ identity scan element


def _proj_dt_bc(x, x_proj, dt_proj, d_state, mask):
    """x_proj → (dt, B, C), dt projected and forced to MASKED_DELTA at
    masked steps. x_proj: (dt_rank + 2·d_state, d_inner); dt_proj:
    (d_inner, dt_rank)."""
    dt_rank = dt_proj.shape[1]
    x_dbl = x @ x_proj.to(x.dtype).t()
    dt = x_dbl[..., :dt_rank] @ dt_proj.to(x.dtype).t()
    if mask is not None:
        dt = torch.where(mask[..., None] > 0, dt,
                         torch.full_like(dt, MASKED_DELTA))
    B = x_dbl[..., dt_rank:dt_rank + d_state].contiguous()
    C = x_dbl[..., dt_rank + d_state:].contiguous()
    return dt, B, C


def mamba_inner(
    xz: torch.Tensor,
    conv_weight: torch.Tensor,
    conv_bias: Optional[torch.Tensor],
    x_proj_weight: torch.Tensor,
    dt_proj_weight: torch.Tensor,
    A: torch.Tensor,
    D: Optional[torch.Tensor] = None,
    delta_bias: Optional[torch.Tensor] = None,
    delta_softplus: bool = True,
    out_proj_weight: Optional[torch.Tensor] = None,
    out_proj_bias: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    return_last_state: bool = False,
    reverse: bool = False,
):
    """One direction of the mixer body.

    Args:
      xz: (batch, seqlen, 2·d_inner), the [x; z] output of in_proj.
      conv_weight: (width, d_inner) depthwise conv taps; conv_bias
        (d_inner,) or None.
      x_proj_weight: (dt_rank + 2·d_state, d_inner); dt_proj_weight:
        (d_inner, dt_rank).
      A: (d_inner, d_state), already -exp(A_log). D, delta_bias:
        (d_inner,).
      out_proj_weight: optional (d_model, d_inner) (and out_proj_bias) to
        apply the output projection.
      mask: optional (batch, seqlen) validity mask: xz is zeroed and dt is
        forced to MASKED_DELTA at masked steps, which become identity scan
        elements.
      return_last_state: also return the (batch, d_inner, d_state) fp32
        state after the last step of the walk.
      reverse: the anti-causal direction without flips: the conv is
        anti-causal and the scan walks backwards (its last state is the
        one at t = 0).

    Returns (batch, seqlen, d_inner), or (batch, seqlen, d_model) with
    out_proj_weight; with return_last_state, (out, last_state).
    """
    d_inner = xz.shape[-1] // 2
    d_state = A.shape[1]
    if mask is not None:
        xz = xz * mask.to(xz.dtype)[..., None]
    x, z = xz[..., :d_inner], xz[..., d_inner:]
    x = causal_conv1d(x, conv_weight, conv_bias, activation="silu",
                      reverse=reverse)
    dt, B, C = _proj_dt_bc(x, x_proj_weight, dt_proj_weight, d_state, mask)
    # A, D and the bias enter the scan in fp32 whatever the parameters'
    # dtype (the kernels take them so; the plain scan computes in fp32)
    y = selective_scan(x, dt, A.float(), B, C,
                       D=None if D is None else D.float(), z=z.contiguous(),
                       delta_bias=(None if delta_bias is None
                                   else delta_bias.float()),
                       delta_softplus=delta_softplus,
                       return_last_state=return_last_state, reverse=reverse)
    last_state = None
    if return_last_state:
        y, last_state = y
    if out_proj_weight is not None:
        y = y @ out_proj_weight.to(y.dtype).t()
        if out_proj_bias is not None:
            y = y + out_proj_bias.to(y.dtype)
    return (y, last_state) if return_last_state else y


def mamba_inner_bidir(
    xz_fwd: torch.Tensor,
    xz_bwd: torch.Tensor,
    fwd: dict,
    bwd: dict,
    A_fwd: torch.Tensor,
    A_bwd: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both directions of a bidirectional mixer with ONE fused scan call.

    Args:
      xz_fwd/xz_bwd: (batch, seqlen, 2·d_inner) per-direction [x; z] streams,
        both in forward time order (ViM passes the same stream twice).
      fwd/bwd: dicts with conv_w (width, d_inner), conv_b, x_proj, dt_proj,
        dt_bias and D.
      A_fwd/A_bwd: (d_inner, d_state), already −exp(A_log).
      mask: optional (batch, seqlen) validity mask; masked steps become
        identity scan elements.

    Returns (out_fwd, out_bwd), both (batch, seqlen, d_inner) in forward
    time order. The anti-causal direction uses the anti-causal conv and the
    scan's in-place backward walk, so nothing is flipped.
    """
    d_inner, d_state = A_fwd.shape
    x, z = xz_fwd[..., :d_inner], xz_fwd[..., d_inner:2 * d_inner]
    xb_raw = xz_bwd[..., :d_inner]
    zb_raw = xz_bwd[..., d_inner:2 * d_inner]
    if mask is not None:
        m = mask.to(xz_fwd.dtype)[..., None]
        x, z = x * m, z * m
        xb_raw, zb_raw = xb_raw * m, zb_raw * m

    xf = causal_conv1d(x, fwd["conv_w"], fwd.get("conv_b"), activation="silu")
    xb = causal_conv1d(xb_raw, bwd["conv_w"], bwd.get("conv_b"),
                       activation="silu", reverse=True)
    dt_f, B_f, C_f = _proj_dt_bc(xf, fwd["x_proj"], fwd["dt_proj"], d_state,
                                 mask)
    dt_b, B_b, C_b = _proj_dt_bc(xb, bwd["x_proj"], bwd["dt_proj"], d_state,
                                 mask)
    zf = z.contiguous()
    zb = zf if xz_bwd is xz_fwd else zb_raw.contiguous()
    return selective_scan_bidir(
        xf, dt_f, A_fwd, B_f, C_f, xb, dt_b, A_bwd, B_b, C_b,
        Df=fwd["D"], zf=zf, biasf=fwd["dt_bias"],
        Db=bwd["D"], zb=zb, biasb=bwd["dt_bias"],
    )
