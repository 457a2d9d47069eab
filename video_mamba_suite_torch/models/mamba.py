"""Bidirectional ViM Mamba mixers (counterparts of the JAX package's
``models/mamba.py``: ``MambaVim`` and ``MambaScanNorm`` with their
``_ScanParams`` bundles and inits).

Takes and returns (batch, seqlen, d_model). Initial values follow the
reference scheme: dt_proj weight ~ U(±dt_rank^-1/2), dt bias =
softplus^-1(LogUniform[0.001, 0.1]), S4D-real A_log = log(1..d_state),
D = 1, drawn from an explicit ``torch.Generator``. The conv has width 4 and
a bias; in_proj and out_proj have none (the suite's only settings).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..ops.mamba_inner import mamba_inner, mamba_inner_bidir
from ..ops.norms import rms_norm
from ..ops.selective_scan_bidir import SHORT_SEQ_MAX
from .common import Dense, init_weight, resolve_device


D_CONV = 4                                   # depthwise conv width
DT_MIN, DT_MAX, DT_INIT_FLOOR = 0.001, 0.1, 1e-4


def _dt_bias(d_inner: int, generator: torch.Generator):
    """Inverse softplus of LogUniform[DT_MIN, DT_MAX] samples."""
    r = torch.rand(d_inner, generator=generator)
    dt = torch.exp(r * (math.log(DT_MAX) - math.log(DT_MIN))
                   + math.log(DT_MIN))
    dt = torch.clamp(dt, min=DT_INIT_FLOOR)
    return dt + torch.log(-torch.expm1(-dt))


class ScanParams(nn.Module):
    """One direction's scan parameters: the depthwise conv taps
    ``conv_w`` (4, d_inner) in the JAX layout and their bias,
    ``x_proj`` (dt_rank + 2·d_state, d_inner), ``dt_proj``
    (d_inner, dt_rank), and the fp32 ``dt_bias``, ``A_log``
    (d_inner, d_state) and ``D``."""

    def __init__(self, d_inner: int, d_state: int, dt_rank: int, *,
                 generator: torch.Generator):
        super().__init__()
        bound = 1.0 / math.sqrt(D_CONV)
        self.conv_w = nn.Parameter(nn.init.uniform_(
            torch.empty(D_CONV, d_inner), -bound, bound,
            generator=generator))
        self.conv_bias = nn.Parameter(torch.zeros(d_inner))
        self.x_proj = nn.Parameter(init_weight(
            (dt_rank + 2 * d_state, d_inner), "torch_linear", generator,
            fan_in=d_inner))
        std = dt_rank ** -0.5
        self.dt_proj = nn.Parameter(nn.init.uniform_(
            torch.empty(d_inner, dt_rank), -std, std, generator=generator))
        self.dt_bias = nn.Parameter(_dt_bias(d_inner, generator))
        a = torch.arange(1, d_state + 1, dtype=torch.float32)
        self.A_log = nn.Parameter(torch.log(a).repeat(d_inner, 1))
        self.D = nn.Parameter(torch.ones(d_inner))

    def param_dict(self) -> dict:
        return dict(conv_w=self.conv_w, conv_b=self.conv_bias,
                    x_proj=self.x_proj, dt_proj=self.dt_proj,
                    dt_bias=self.dt_bias, D=self.D)

    def A(self) -> torch.Tensor:
        return -torch.exp(self.A_log)

    def forward(self, xz: torch.Tensor, mask: Optional[torch.Tensor] = None,
                return_last_state: bool = False, reverse: bool = False):
        """This direction's mixer body on xz (batch, seqlen, 2·d_inner)
        through ``mamba_inner`` (the JAX ``_ScanParams.__call__``)."""
        return mamba_inner(
            xz, self.conv_w, self.conv_bias, self.x_proj, self.dt_proj,
            self.A(), D=self.D, delta_bias=self.dt_bias,
            delta_softplus=True, mask=mask,
            return_last_state=return_last_state, reverse=reverse)


def use_fused_scan(seqlen: int) -> bool:
    """The JAX ``_use_fuse_scan`` rule: sequences whose length rounded up
    to 8 is at most ``SHORT_SEQ_MAX`` take the fused bidirectional scan
    (kernel K1 on the card); longer ones take one chunked scan per
    direction (kernel K3)."""
    return -(-seqlen // 8) * 8 <= SHORT_SEQ_MAX


class MambaVim(nn.Module):
    """Bidirectional Mamba, "bimamba v2" (the ViM mixer):

        out = out_proj(scan_f(xz) + flip(scan_b(flip(xz))) [/2])

    with separate ``fwd`` and ``bwd`` parameter bundles. Sequences whose
    length rounded up to 8 is at most 64 run both directions in one fused
    scan (kernel K1 on CUDA); longer ones run ``fwd`` causally and ``bwd``
    anti-causally (``reverse=True``, no flips), one chunked scan each
    (kernel K3 on CUDA, K4 in the backward). On the CPU the same routing
    takes the plain versions.
    """

    def __init__(self, d_model: int, d_state: int = 16, expand: int = 2,
                 if_devide_out: bool = False,
                 dtype: Optional[torch.dtype] = None, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        d_inner = int(expand * d_model)
        dt_rank = math.ceil(d_model / 16)
        self.if_devide_out = if_devide_out
        self.in_proj = Dense(d_model, 2 * d_inner, bias=False, dtype=dtype,
                             init="torch_linear", generator=generator)
        self.fwd = ScanParams(d_inner, d_state, dt_rank, generator=generator)
        self.bwd = ScanParams(d_inner, d_state, dt_rank, generator=generator)
        self.out_proj = Dense(d_inner, d_model, bias=False, dtype=dtype,
                              init="torch_linear", generator=generator)
        self.to(device)

    def _directions(self, hidden_states: torch.Tensor,
                    mask: Optional[torch.Tensor]) -> torch.Tensor:
        """in_proj, then the sum of both directions' scans."""
        xz = self.in_proj(hidden_states)                  # (b, l, 2·d_inner)
        if use_fused_scan(xz.shape[1]):
            out_f, out_b = mamba_inner_bidir(
                xz, xz, self.fwd.param_dict(), self.bwd.param_dict(),
                self.fwd.A(), self.bwd.A(), mask=mask)
        else:
            out_f = self.fwd(xz, mask=mask)
            out_b = self.bwd(xz, mask=mask, reverse=True)
        return out_f + out_b

    def forward(self, hidden_states: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        out = self._directions(hidden_states, mask)
        if self.if_devide_out:
            out = out / 2
        return self.out_proj(out)


class MambaScanNorm(MambaVim):
    """ViM with RMSNorm(d_inner) (weight ``scan_norm_w``) on the sum of the
    two directions before out_proj, in place of the /2 (the JAX
    ``MambaScanNorm``; ``if_devide_out`` is ignored, as there)."""

    def __init__(self, d_model: int, d_state: int = 16, expand: int = 2,
                 if_devide_out: bool = False,
                 dtype: Optional[torch.dtype] = None, device="cuda",
                 generator: Optional[torch.Generator] = None):
        device = resolve_device(device)
        super().__init__(d_model, d_state, expand, if_devide_out, dtype,
                         device="cpu", generator=generator)
        self.scan_norm_w = nn.Parameter(torch.ones(int(expand * d_model)))
        self.to(device)

    def forward(self, hidden_states: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        out = rms_norm(self._directions(hidden_states, mask),
                       self.scan_norm_w)
        return self.out_proj(out)
