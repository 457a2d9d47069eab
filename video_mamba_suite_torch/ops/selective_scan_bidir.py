"""Fused bidirectional short selective scan (kernels K1 and K2).

Counterpart of the JAX package's ``selective_scan_pallas_bidir`` and its
Pallas kernels ``_short_bidir_fwd_kernel`` and ``_short_bidir_bwd_kernel``
(``video_mamba_suite_tpu/ops/selective_scan_pallas.py``). Both directions
of a bidirectional mixer run in one launch: direction f scans causally,
direction b anti-causally (the same function as flip∘scan∘flip). All inputs
and both outputs are in forward time order.

``selective_scan_bidir`` takes the plain version ``selective_scan_bidir_ref``
(and its autograd) for tensors on the CPU. For tensors on a CUDA device it
goes through an autograd Function whose forward launches K1
(``csrc/short_bidir_fwd.cu``) and whose backward launches K2
(``csrc/short_bidir_bwd.cu``) through ``selective_scan_bidir_bwd``. The
Function keeps the inputs, not the scan's states, so the backward does not
run K1 again.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ._build import launch, library, ptr
from .selective_scan import selective_scan_ref
from .selective_scan_short import SHORT_SEQ_MAX

KERNEL = "short_bidir_fwd"
BWD_KERNEL = "short_bidir_bwd"
MAX_DSTATE = 16      # largest state size the kernels take
BWD_ROW_GROUPS = 256  # most row groups (partials of dA, dD, dbias) of K2
BWD_CHANNELS = 128   # channels per K2 block (one partial of dB, dC each)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# The 16 inputs, in the order of ``selective_scan_bidir``'s parameters.
INPUTS = ("uf", "dtf", "Af", "Bf", "Cf", "ub", "dtb", "Ab", "Bb", "Cb",
          "Df", "zf", "biasf", "Db", "zb", "biasb")
# The 8 gradients of one direction, in the JAX package's order.
GRADS = ("u", "dt", "A", "B", "C", "D", "z", "bias")


def _flip(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if x is None else torch.flip(x, dims=(1,))


def selective_scan_bidir_ref(
    uf, dtf, Af, Bf, Cf, ub, dtb, Ab, Bb, Cb,
    Df=None, zf=None, biasf=None, Db=None, zb=None, biasb=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: a causal scan and flip∘scan∘flip, softplus on dt."""
    out_f = selective_scan_ref(uf, dtf, Af, Bf, Cf, D=Df, z=zf,
                               delta_bias=biasf, delta_softplus=True)
    out_b = _flip(selective_scan_ref(
        _flip(ub), _flip(dtb), Ab, _flip(Bb), _flip(Cb), D=Db, z=_flip(zb),
        delta_bias=biasb, delta_softplus=True))
    return out_f, out_b


def selective_scan_bidir_bwd_ref(
    uf, dtf, Af, Bf, Cf, ub, dtb, Ab, Bb, Cb,
    Df=None, zf=None, biasf=None, Db=None, zb=None, biasb=None, *, gf, gb,
) -> Tuple[Optional[torch.Tensor], ...]:
    """Plain version of K2: the VJP of ``selective_scan_bidir_ref`` at the
    16 inputs for the cotangents ``gf`` and ``gb`` of its two outputs.

    Returns 16 gradients, ``(du, ddt, dA, dB, dC, dD, dz, dbias)`` of
    direction f and then of direction b, each in its input's dtype (dB and
    dC are summed in fp32 before the cast), None for an input that is None.
    ``zf`` and ``zb`` get a gradient each even when they are one tensor.
    """
    given = dict(zip(INPUTS, (uf, dtf, Af, Bf, Cf, ub, dtb, Ab, Bb, Cb,
                              Df, zf, biasf, Db, zb, biasb)))
    with torch.enable_grad():
        leaves = {k: v.detach().requires_grad_()
                  for k, v in given.items() if v is not None}
        outs = selective_scan_bidir_ref(**{k: leaves.get(k) for k in INPUTS})
        found = torch.autograd.grad(outs, list(leaves.values()), (gf, gb))
    found = dict(zip(leaves, found))
    return tuple(found.get(name + s) for s in "fb" for name in GRADS)


def _check_cuda_args(uf, dtf, Af, Bf, Cf, ub, dtb, Ab, Bb, Cb,
                     Df, zf, biasf, Db, zb, biasb, gf=None, gb=None):
    if uf.dim() != 3:
        raise ValueError(f"u must be (batch, seqlen, dim), got "
                         f"{tuple(uf.shape)}")
    batch, seqlen, dim = uf.shape
    if Bf.dim() != 3 or Bb.dim() != 3:
        raise ValueError("grouped (rank-4) B/C are not supported by the "
                         "fused bidirectional scan; B and C must be "
                         "(batch, seqlen, dstate)")
    dstate = Bf.shape[-1]
    if seqlen > SHORT_SEQ_MAX:
        raise ValueError(f"seqlen {seqlen} > {SHORT_SEQ_MAX}: the fused "
                         "bidirectional scan is short-sequence only")
    if dstate > MAX_DSTATE:
        raise ValueError(f"dstate {dstate} > {MAX_DSTATE} is not supported")
    io_dtype = uf.dtype
    if io_dtype not in _DTYPE_CODES:
        raise TypeError(f"u must be float32 or bfloat16, got {io_dtype}")
    shapes = {
        "u": (batch, seqlen, dim), "dt": (batch, seqlen, dim),
        "z": (batch, seqlen, dim), "B": (batch, seqlen, dstate),
        "C": (batch, seqlen, dstate), "A": (dim, dstate), "D": (dim,),
        "bias": (dim,), "g": (batch, seqlen, dim),
    }
    named = {
        "uf": uf, "dtf": dtf, "zf": zf, "Bf": Bf, "Cf": Cf, "Af": Af,
        "Df": Df, "biasf": biasf, "gf": gf, "ub": ub, "dtb": dtb, "zb": zb,
        "Bb": Bb, "Cb": Cb, "Ab": Ab, "Db": Db, "biasb": biasb, "gb": gb,
    }
    for name, t in named.items():
        if t is None:
            continue
        kind = name[:-1]
        want_dtype = torch.float32 if kind in ("A", "D", "bias") else io_dtype
        if t.device != uf.device:
            raise ValueError(f"{name} is on {t.device}, u on {uf.device}")
        if t.dtype != want_dtype:
            raise TypeError(f"{name} must be {want_dtype}, got {t.dtype}")
        if tuple(t.shape) != shapes[kind]:
            raise ValueError(f"{name} must have shape {shapes[kind]}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return batch, seqlen, dim, dstate


def _launch_fwd(uf, dtf, Af, Bf, Cf, ub, dtb, Ab, Bb, Cb,
                Df, zf, biasf, Db, zb, biasb):
    batch, seqlen, dim, dstate = _check_cuda_args(
        uf, dtf, Af, Bf, Cf, ub, dtb, Ab, Bb, Cb, Df, zf, biasf, Db, zb,
        biasb)
    out_f = torch.empty_like(uf)
    out_b = torch.empty_like(uf)
    if uf.numel() == 0:
        return out_f, out_b
    launch(KERNEL, library(KERNEL, 5, 18), uf.device,
           _DTYPE_CODES[uf.dtype], batch, seqlen, dim, dstate,
           *(ptr(t) for t in (uf, dtf, zf, Bf, Cf, Af, Df, biasf,
                              ub, dtb, zb, Bb, Cb, Ab, Db, biasb,
                              out_f, out_b)))
    return out_f, out_b


def _launch_bwd(uf, dtf, Af, Bf, Cf, ub, dtb, Ab, Bb, Cb,
                Df, zf, biasf, Db, zb, biasb, gf, gb):
    batch, seqlen, dim, dstate = _check_cuda_args(
        uf, dtf, Af, Bf, Cf, ub, dtb, Ab, Bb, Cb, Df, zf, biasf, Db, zb,
        biasb, gf, gb)
    groups = max(1, min(batch, BWD_ROW_GROUPS))
    blocks = -(-dim // BWD_CHANNELS)

    # the kernel writes every element of its outputs and partials
    alloc = torch.empty if uf.numel() else torch.zeros

    def outputs(u, z):
        f32 = dict(dtype=torch.float32, device=u.device)
        return dict(
            u=torch.empty_like(u), dt=torch.empty_like(u),
            z=None if z is None else torch.empty_like(z),
            A=alloc(groups, dim, dstate, **f32),
            B=alloc(blocks, batch, seqlen, dstate, **f32),
            C=alloc(blocks, batch, seqlen, dstate, **f32),
            D=alloc(groups, dim, **f32),
            bias=alloc(groups, dim, **f32))

    parts = {"f": outputs(uf, zf), "b": outputs(ub, zb)}
    if uf.numel() > 0:
        ptrs = [ptr(parts[s][k]) for s in "fb"
                for k in ("u", "dt", "z", "A", "B", "C", "D", "bias")]
        launch(BWD_KERNEL, library(BWD_KERNEL, 6, 34), uf.device,
               _DTYPE_CODES[uf.dtype], batch, seqlen, dim, dstate, groups,
               *(ptr(t) for t in (uf, dtf, zf, Bf, Cf, Af, Df, biasf, gf,
                                  ub, dtb, zb, Bb, Cb, Ab, Db, biasb, gb)),
               *ptrs)

    def reduce(part, B, D, bias):
        return (part["u"], part["dt"], part["A"].sum(0),
                part["B"].sum(0).to(B.dtype), part["C"].sum(0).to(B.dtype),
                None if D is None else part["D"].sum(0), part["z"],
                None if bias is None else part["bias"].sum(0))

    return (reduce(parts["f"], Bf, Df, biasf)
            + reduce(parts["b"], Bb, Db, biasb))


def selective_scan_bidir_bwd(
    uf, dtf, Af, Bf, Cf, ub, dtb, Ab, Bb, Cb,
    Df=None, zf=None, biasf=None, Db=None, zb=None, biasb=None, *, gf, gb,
) -> Tuple[Optional[torch.Tensor], ...]:
    """Gradients of ``selective_scan_bidir`` for the cotangents ``gf`` and
    ``gb``, in the order and dtypes of ``selective_scan_bidir_bwd_ref``.

    CUDA tensors launch K2 (the same limits as K1; g* contiguous, in u's
    dtype) or raise; CPU tensors take the plain version.
    """
    args = (uf, dtf, Af, Bf, Cf, ub, dtb, Ab, Bb, Cb,
            Df, zf, biasf, Db, zb, biasb)
    if uf.device.type == "cuda":
        return _launch_bwd(*args, gf, gb)
    if uf.device.type == "cpu":
        return selective_scan_bidir_bwd_ref(*args, gf=gf, gb=gb)
    raise ValueError(f"unsupported device {uf.device}")


class _FusedBidirScan(torch.autograd.Function):
    """K1 forward, K2 backward. Saves the 16 inputs; the gradients of an
    input passed twice (ViM's ``zb is zf``) are summed by autograd."""

    @staticmethod
    def forward(ctx, *args):
        ctx.save_for_backward(*args)
        return _launch_fwd(*args)

    @staticmethod
    def backward(ctx, gf, gb):
        saved = ctx.saved_tensors
        grads = _launch_bwd(*saved, gf.contiguous(), gb.contiguous())
        by_name = dict(zip((name + s for s in "fb" for name in GRADS),
                           grads))          # the names of INPUTS
        return tuple(by_name[k] if need else None
                     for k, need in zip(INPUTS, ctx.needs_input_grad))


def selective_scan_bidir(
    uf, dtf, Af, Bf, Cf, ub, dtb, Ab, Bb, Cb,
    Df=None, zf=None, biasf=None, Db=None, zb=None, biasb=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both directions of a bidirectional mixer in one fused scan.

    Args (f: causal direction, b: anti-causal direction):
      u*, dt*, z*: (batch, seqlen, dim), float32 or bfloat16.
      B*, C*: (batch, seqlen, dstate), u's dtype.
      A*: (dim, dstate) float32, already -exp(A_log).
      D*, bias*: (dim,) float32; dt becomes softplus(dt + bias) in fp32.
    Returns (out_f, out_b), both (batch, seqlen, dim) in u's dtype and in
    forward time order.

    CUDA tensors launch the kernels (seqlen <= 64, dstate <= 16, contiguous;
    K1 forward, K2 in the backward) or raise; CPU tensors take the plain
    version.
    """
    args = (uf, dtf, Af, Bf, Cf, ub, dtb, Ab, Bb, Cb,
            Df, zf, biasf, Db, zb, biasb)
    if uf.device.type == "cuda":
        return _FusedBidirScan.apply(*args)
    if uf.device.type == "cpu":
        return selective_scan_bidir_ref(*args)
    raise ValueError(f"unsupported device {uf.device}")
