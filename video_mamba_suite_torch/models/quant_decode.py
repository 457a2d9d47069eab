"""Offline int8 weights for serving the Mamba LM (counterpart of the JAX
package's ``models/quant_decode.py``).

``quantize_lm_for_decode`` stores the large matrices of a
``MambaLMHeadModel`` as int8 with fp32 scales, symmetric absmax:
  * every mixer's ``in_proj`` and ``out_proj`` weight, one scale per
    output channel (the JAX (in, out) kernel's axis 0; dim 1 of the
    port's (out, in) weight), applied to the product;
  * the embedding table, one scale per row, applied after the lookup and,
    through the tied head, to the logits' vocabulary columns.
Scales are floored at 1e-8, and the rounding is half to even, so the int8
tensors are the JAX package's bit for bit. Every other fp32 parameter
(``x_proj``, ``dt_proj``, the conv, ``A_log``, ``D``, ``dt_bias``, the
norms) is cast to ``cast``, as the JAX function casts every remaining
fp32 leaf. ``W8Dense`` and ``W8Embed`` (``models/common.py``) then read
the int8 weights; ``forward``, ``prefill``, ``step`` and ``generate`` run
unchanged.

The int8 matrices are widened to bf16 by a plain cast before each
product, so on the card the step still reads a bf16 copy of each weight:
this halves the stored bytes, not yet the bytes a decode step streams.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .common import W8Dense, W8Embed


def quantize_lm_for_decode(model: nn.Module,
                           cast: Optional[torch.dtype] = torch.bfloat16
                           ) -> nn.Module:
    """Quantize ``model`` (a ``MambaLMHeadModel``) in place for serving:
    its ``W8Dense`` projections per output channel and its ``W8Embed``
    table per row to int8, then every remaining fp32 parameter cast to
    ``cast`` (None keeps fp32). Returns the model."""
    for module in model.modules():
        if isinstance(module, (W8Dense, W8Embed)) and module.qscale is None:
            module.quantize_()
    if cast is not None:
        for p in model.parameters():
            if p.dtype == torch.float32:
                p.data = p.data.to(cast)
    return model
