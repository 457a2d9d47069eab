"""Mamba mixers and the pre-norm block (counterparts of the JAX
package's ``models/mamba.py``: the bidirectional ``MambaVim`` and
``MambaScanNorm``, the decomposed bidirectional ``MambaDBM``, the causal
``MambaCausal`` with its decode ``step`` and ``prefill``, their
``_ScanParams`` bundles and inits, ``Block`` and ``make_block``).

Mixers take and return (batch, seqlen, d_model). Initial values follow the
reference scheme: dt_proj weight ~ U(±dt_rank^-1/2), dt bias =
softplus^-1(LogUniform[0.001, 0.1]), S4D-real A_log = log(1..d_state),
D = 1, drawn from an explicit ``torch.Generator``. The conv has a bias
(width 4 unless ``d_conv`` says otherwise); in_proj and out_proj have none
(the suite's only settings).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.causal_conv1d import causal_conv1d_update
from ..ops.mamba_inner import mamba_inner, mamba_inner_bidir
from ..ops.norms import fused_add_norm, rms_norm
from ..ops.selective_scan_short import use_short_scan
from ..ops.selective_state_update import selective_state_update
from .common import Dense, W8Dense, init_weight, resolve_device


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
    ``conv_w`` (d_conv, d_inner) in the JAX layout and their bias,
    ``x_proj`` (dt_rank + 2·d_state, d_inner), ``dt_proj``
    (d_inner, dt_rank), and the fp32 ``dt_bias``, ``A_log``
    (d_inner, d_state) and ``D``."""

    def __init__(self, d_inner: int, d_state: int, dt_rank: int, *,
                 generator: torch.Generator, d_conv: int = D_CONV):
        super().__init__()
        bound = 1.0 / math.sqrt(d_conv)
        self.conv_w = nn.Parameter(nn.init.uniform_(
            torch.empty(d_conv, d_inner), -bound, bound,
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
    return use_short_scan(seqlen)


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
                 generator: Optional[torch.Generator] = None,
                 d_conv: int = D_CONV):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        d_inner = int(expand * d_model)
        dt_rank = math.ceil(d_model / 16)
        self.if_devide_out = if_devide_out
        self.in_proj = Dense(d_model, 2 * d_inner, bias=False, dtype=dtype,
                             init="torch_linear", generator=generator)
        self.fwd = ScanParams(d_inner, d_state, dt_rank, generator=generator,
                              d_conv=d_conv)
        self.bwd = ScanParams(d_inner, d_state, dt_rank, generator=generator,
                              d_conv=d_conv)
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


class MambaDBM(nn.Module):
    """Decomposed bidirectional Mamba (the suite's ``mamba_new.Mamba``, the
    JAX ``MambaDBM``): one in_proj gives two (x, z) streams, 4·d_inner
    wide; both directions scan with ONE ``shared`` parameter bundle, the
    first stream causally and the second anti-causally; the two outputs
    are concatenated along the channels into out_proj (2·d_inner →
    d_model). The task suites build it with expand 1.

    The route is ``MambaVim``'s: up to 64 steps (length rounded up to 8)
    one fused scan of both directions with the shared parameters passed
    twice (kernel K1 on CUDA, K2 in the backward); longer sequences one
    chunked scan per direction (K3, K4 in the backward). Autograd adds
    both directions' gradients into the shared parameters.
    """

    def __init__(self, d_model: int, d_state: int = 16, expand: int = 2,
                 d_conv: int = D_CONV, dtype: Optional[torch.dtype] = None,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.d_inner = int(expand * d_model)
        dt_rank = math.ceil(d_model / 16)
        self.in_proj = Dense(d_model, 4 * self.d_inner, bias=False,
                             dtype=dtype, init="torch_linear",
                             generator=generator)
        self.shared = ScanParams(self.d_inner, d_state, dt_rank,
                                 generator=generator, d_conv=d_conv)
        self.out_proj = Dense(2 * self.d_inner, d_model, bias=False,
                              dtype=dtype, init="torch_linear",
                              generator=generator)
        self.to(device)

    def forward(self, hidden_states: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """hidden_states (batch, seqlen, d_model), mask (batch, seqlen) or
        None → (batch, seqlen, d_model)."""
        xz = self.in_proj(hidden_states)                  # (b, l, 4·d_inner)
        xz_f, xz_b = xz[..., :2 * self.d_inner], xz[..., 2 * self.d_inner:]
        if use_fused_scan(xz.shape[1]):
            p = self.shared.param_dict()
            A = self.shared.A()
            out_f, out_b = mamba_inner_bidir(xz_f, xz_b, p, p, A, A,
                                             mask=mask)
        else:
            out_f = self.shared(xz_f, mask=mask)
            out_b = self.shared(xz_b, mask=mask, reverse=True)
        return self.out_proj(torch.cat([out_f, out_b], dim=-1))


class MambaCausal(nn.Module):
    """Unidirectional Mamba (upstream mamba_ssm semantics; the Mamba LM's
    mixer) with streaming decode: ``forward`` runs the whole sequence,
    ``prefill`` also returns the decode state, ``step`` advances one
    token. One ``fwd`` scan bundle, as the JAX tree has it.

    On CUDA, ``forward`` and ``prefill`` scan through kernel K5 (and K6
    in a backward) when the sequence (rounded up to 8) is at most 64
    steps, else through K3 (and K4 in a backward); ``step`` is plain torch
    (``causal_conv1d_update``, ``selective_state_update``), as the JAX
    package's is plain jnp.
    """

    def __init__(self, d_model: int, d_state: int = 16, d_conv: int = D_CONV,
                 expand: int = 2, dtype: Optional[torch.dtype] = None,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.d_state, self.d_conv = d_state, d_conv
        self.d_inner = int(expand * d_model)
        self.dt_rank = math.ceil(d_model / 16)
        # W8Dense: exactly Dense until quantize_lm_for_decode stores the
        # projections as int8 (models/quant_decode.py)
        self.in_proj = W8Dense(d_model, 2 * self.d_inner, bias=False,
                               dtype=dtype, init="torch_linear",
                               generator=generator)
        self.fwd = ScanParams(self.d_inner, d_state, self.dt_rank,
                              generator=generator, d_conv=d_conv)
        self.out_proj = W8Dense(self.d_inner, d_model, bias=False,
                                dtype=dtype, init="torch_linear",
                                generator=generator)
        self.to(device)

    def forward(self, hidden_states: torch.Tensor) -> torch.Tensor:
        return self.out_proj(self.fwd(self.in_proj(hidden_states)))

    def init_state(self, batch: int, dtype: torch.dtype = torch.float32
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Zero (conv_state (batch, d_conv, d_inner) in ``dtype``,
        ssm_state (batch, d_inner, d_state) fp32)."""
        device = self.fwd.A_log.device
        return (torch.zeros(batch, self.d_conv, self.d_inner, dtype=dtype,
                            device=device),
                torch.zeros(batch, self.d_inner, self.d_state,
                            dtype=torch.float32, device=device))

    def prefill(self, hidden_states: torch.Tensor):
        """The whole prompt (batch, L, d_model) in one pass, returning (out
        (batch, L, d_model), (conv_state, ssm_state)): the state that L
        ``step`` calls would reach. conv_state holds the last d_conv raw
        (pre-conv) x rows, oldest first, left-padded with zeros when the
        prompt is shorter, in fp32; ssm_state is the scan's last state."""
        xz = self.in_proj(hidden_states)
        x = xz[..., :self.d_inner]
        y, ssm_state = self.fwd(xz, return_last_state=True)
        L = x.shape[1]
        if L >= self.d_conv:
            conv_state = x[:, L - self.d_conv:]
        else:
            conv_state = F.pad(x, (0, 0, self.d_conv - L, 0))
        conv_state = conv_state.float().contiguous()
        return self.out_proj(y), (conv_state, ssm_state)

    def step(self, x_t: torch.Tensor, state):
        """One decode token, x_t (batch, d_model) → (out (batch, d_model),
        new (conv_state, ssm_state))."""
        conv_state, ssm_state = state
        p = self.fwd
        xz = self.in_proj(x_t)
        x, z = xz[..., :self.d_inner], xz[..., self.d_inner:]
        x, conv_state = causal_conv1d_update(
            x, conv_state, p.conv_w, p.conv_bias, activation="silu")
        x_db = x @ p.x_proj.to(x.dtype).t()
        dt = x_db[..., :self.dt_rank] @ p.dt_proj.to(x.dtype).t()
        B = x_db[..., self.dt_rank:self.dt_rank + self.d_state]
        C = x_db[..., self.dt_rank + self.d_state:]
        y, ssm_state = selective_state_update(
            ssm_state, x, dt, p.A(), B, C, D=p.D, z=z, dt_bias=p.dt_bias,
            dt_softplus=True)
        return self.out_proj(y), (conv_state, ssm_state)


class Block(nn.Module):
    """Pre-norm residual block: add → norm → mixer, carrying (hidden,
    residual) so the add and the norm stay one step (``fused_add_norm``
    with ``prenorm=True``; the residual in fp32 with ``residual_in_fp32``).
    ``norm_w`` (and ``norm_b`` unless ``rms``) are the norm's parameters.
    ``step`` and ``prefill`` need a mixer that has them (``MambaCausal``).
    """

    def __init__(self, dim: int, mixer: nn.Module, norm_eps: float = 1e-5,
                 rms: bool = False, residual_in_fp32: bool = True):
        super().__init__()
        self.norm_eps, self.rms = norm_eps, rms
        self.residual_in_fp32 = residual_in_fp32
        device = next(mixer.parameters()).device
        self.norm_w = nn.Parameter(torch.ones(dim, device=device))
        self.norm_b = (None if rms
                       else nn.Parameter(torch.zeros(dim, device=device)))
        self.mixer = mixer

    def _add_norm(self, hidden_states, residual):
        return fused_add_norm(
            hidden_states, self.norm_w, self.norm_b, residual=residual,
            prenorm=True, residual_in_fp32=self.residual_in_fp32,
            eps=self.norm_eps, is_rms_norm=self.rms)

    def forward(self, hidden_states: torch.Tensor,
                residual: Optional[torch.Tensor] = None):
        """(hidden (batch, L, dim), residual or None) → (hidden,
        residual)."""
        hidden_states, residual = self._add_norm(hidden_states, residual)
        return self.mixer(hidden_states), residual

    def step(self, hidden_states, residual, state):
        """One token: hidden (batch, dim) → (hidden, residual, state)."""
        hidden_states, residual = self._add_norm(hidden_states, residual)
        hidden_states, state = self.mixer.step(hidden_states, state)
        return hidden_states, residual, state

    def prefill(self, hidden_states, residual=None):
        """The whole prompt, also returning the mixer's decode state:
        (hidden, residual, state)."""
        hidden_states, residual = self._add_norm(hidden_states, residual)
        hidden_states, state = self.mixer.prefill(hidden_states)
        return hidden_states, residual, state


_MIXERS = {"vim": MambaVim, "dbm": MambaDBM, "scan_norm": MambaScanNorm,
           "causal": MambaCausal}


def make_block(d_model: int, mixer: str = "vim",
               rms_norm_block: bool = False, residual_in_fp32: bool = True,
               norm_eps: float = 1e-5, **mixer_kwargs) -> Block:
    """A ``Block`` around a new mixer of kind ``mixer`` ("vim", "dbm",
    "scan_norm" or "causal"; the JAX ``make_block``); ``mixer_kwargs``
    go to the mixer (``d_state``, ``expand``, ``device``, ``generator``,
    ...)."""
    if mixer not in _MIXERS:
        raise ValueError(f"unknown mixer {mixer!r}; expected one of "
                         f"{sorted(_MIXERS)}")
    return Block(d_model, _MIXERS[mixer](d_model, **mixer_kwargs),
                 norm_eps=norm_eps, rms=rms_norm_block,
                 residual_in_fp32=residual_in_fp32)
