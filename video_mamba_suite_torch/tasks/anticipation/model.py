"""LSTR-Mamba: the long/work-memory anticipation model with streaming
inference (counterpart of the JAX package's
``tasks/anticipation/model.py``: ``NormalizedLinear``, ``FeatureHead`` and
``LSTRMamba``).

The long-memory, work-memory and anticipation-query tokens form one
sequence for a stack of causal Mamba blocks (``make_block("causal")`` with
RMSNorm) and a final RMSNorm; the work and anticipation positions are
classified. On the card each block's scan runs K5 (and K6 in a backward)
when the sequence, rounded up to 8, is at most 64 tokens, else K3 (and
K4). Streaming carries each layer's (conv, ssm) state through
``MambaCausal.step``, plain torch.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...models.common import (
    Dense,
    dropout,
    init_weight,
    resolve_device,
    sinusoid_positions,
)
from ...models.mamba import make_block
from ...ops.norms import fused_add_norm

State = Tuple[torch.Tensor, torch.Tensor]


class NormalizedLinear(nn.Module):
    """Cosine classifier: logits = scale · (x/|x|) @ (W/|W|)ᵀ, each row of
    ``weight`` (out, in) normalised over the input axis (the JAX kernel is
    (in, out), normalised over its first axis). No bias."""

    def __init__(self, in_features: int, features: int, scale: float = 20.0,
                 *, generator: torch.Generator):
        super().__init__()
        self.scale = scale
        self.weight = nn.Parameter(init_weight(
            (features, in_features), "lecun_normal", generator,
            fan_in=in_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        xn = xf / torch.sqrt(torch.sum(xf * xf, -1, keepdim=True) + 1e-8)
        w = self.weight
        wn = w / torch.sqrt(torch.sum(w * w, 1, keepdim=True) + 1e-8)
        return (self.scale * xn @ wn.t()).to(x.dtype)


class FeatureHead(nn.Module):
    """Concatenate visual, motion and object features (each optional but
    the first), then ``fusion`` (Dense to d_model) and ReLU."""

    def __init__(self, in_features: int, d_model: int, *,
                 generator: torch.Generator):
        super().__init__()
        self.fusion = Dense(in_features, d_model, generator=generator)

    def forward(self, visual, motion=None, obj=None) -> torch.Tensor:
        x = torch.cat([t for t in (visual, motion, obj) if t is not None],
                      dim=-1)
        return F.relu(self.fusion(x))


class LSTRMamba(nn.Module):
    """The anticipation model. ``forward(visual, motion)`` takes
    (batch, long + work, visual_dim) and (batch, long + work, motion_dim)
    features and returns {"score": (batch, work + anticipation,
    num_classes)} and, with verb and noun heads, "score_verb" and
    "score_noun". ``dropout_cls`` drops the classified tokens in training
    mode, its mask drawn from the ``generator`` given to ``forward``."""

    def __init__(self, visual_dim: int, motion_dim: int = 0,
                 d_model: int = 1024, num_classes: int = 3807,
                 num_verbs: int = 0, num_nouns: int = 0,
                 long_memory_num_samples: int = 512,
                 work_memory_num_samples: int = 32,
                 anticipation_num_samples: int = 0, mamba_layers: int = 2,
                 dropout_cls: float = 0.0, fc_norm: bool = False,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.d_model = d_model
        self.long_memory_num_samples = long_memory_num_samples
        self.work_memory_num_samples = work_memory_num_samples
        self.anticipation_num_samples = anticipation_num_samples
        self.dropout_cls = dropout_cls
        in_features = visual_dim + motion_dim
        self.head_long = FeatureHead(in_features, d_model,
                                     generator=generator)
        self.head_work = FeatureHead(in_features, d_model,
                                     generator=generator)
        self.blocks = nn.ModuleList(
            make_block(d_model, mixer="causal", rms_norm_block=True,
                       device="cpu", generator=generator)
            for _ in range(mamba_layers))
        self.norm_f_w = nn.Parameter(torch.ones(d_model))
        self.dec_query = None
        if anticipation_num_samples > 0:
            self.dec_query = nn.Parameter(0.02 * torch.randn(
                anticipation_num_samples, d_model, generator=generator))
        if fc_norm:
            self.classifier = NormalizedLinear(d_model, num_classes,
                                               generator=generator)
        else:
            self.classifier = Dense(d_model, num_classes,
                                    generator=generator)
        self.classifier_verb = (Dense(d_model, num_verbs,
                                      generator=generator)
                                if num_verbs else None)
        self.classifier_noun = (Dense(d_model, num_nouns,
                                      generator=generator)
                                if num_nouns else None)
        self.to(device)

    def _final_norm(self, hidden, residual):
        hidden, _ = fused_add_norm(hidden, self.norm_f_w, None,
                                   residual=residual, prenorm=False,
                                   is_rms_norm=True)
        return hidden

    def _encode(self, tokens: torch.Tensor) -> torch.Tensor:
        hidden, residual = tokens, None
        for blk in self.blocks:
            hidden, residual = blk(hidden, residual)
        return self._final_norm(hidden, residual)

    def _tokens(self, visual, motion):
        """[long; work; anticipation] tokens with the sinusoid positions."""
        L = self.long_memory_num_samples
        long_m = None if motion is None else motion[:, :L]
        work_m = None if motion is None else motion[:, L:]
        long_tok = self.head_long(visual[:, :L], long_m)
        work_tok = self.head_work(visual[:, L:], work_m)
        W = work_tok.shape[1]
        pe = sinusoid_positions(L + W + self.anticipation_num_samples,
                                self.d_model, device=long_tok.device)
        pe = pe.to(long_tok.dtype)
        toks = [long_tok + pe[None, :L], work_tok + pe[None, L:L + W]]
        if self.dec_query is not None:
            toks.append(self.dec_query[None].expand(visual.shape[0], -1, -1)
                        + pe[None, L + W:])
        return torch.cat(toks, dim=1), L

    def forward(self, visual: torch.Tensor,
                motion: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        tokens, L = self._tokens(visual, motion)
        out_tokens = self._encode(tokens)[:, L:]   # work + anticipation
        out_tokens = dropout(out_tokens, self.dropout_cls, self.training,
                             generator)
        out = {"score": self.classifier(out_tokens)}
        if self.classifier_verb is not None:
            out["score_verb"] = self.classifier_verb(out_tokens)
        if self.classifier_noun is not None:
            out["score_noun"] = self.classifier_noun(out_tokens)
        return out

    # -- streaming inference ------------------------------------------------

    def init_stream(self, batch: int) -> List[State]:
        """Each layer's zero (conv_state, ssm_state)."""
        return [blk.mixer.init_state(batch) for blk in self.blocks]

    def stream_step(self, token: torch.Tensor, states: List[State]):
        """One fused token (batch, d_model) through the causal stack:
        (scores (batch, num_classes), new states)."""
        hidden, residual = token, None
        new_states = []
        for blk, st in zip(self.blocks, states):
            hidden, residual, st = blk.step(hidden, residual, st)
            new_states.append(st)
        return self.classifier(self._final_norm(hidden, residual)), new_states

    def embed_work_token(self, visual: torch.Tensor,
                         motion: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
        """One frame's fused token, (batch, visual_dim) → (batch, d_model).
        No positional encoding is added (as in the JAX package)."""
        return self.head_work(visual, motion)

    def stream_prefill(self, tokens: torch.Tensor):
        """Warm the streaming states from a (batch, L, d_model) history of
        fused tokens in one pass: ((batch, L, num_classes) scores, states),
        the states where L ``stream_step`` calls would leave them."""
        hidden, residual = tokens, None
        states = []
        for blk in self.blocks:
            hidden, residual, st = blk.prefill(hidden, residual)
            states.append(st)
        return self.classifier(self._final_norm(hidden, residual)), states
