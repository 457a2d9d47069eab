"""The Mamba language model (counterparts of the JAX package's
``models/mixer_seq.py``: ``MixerModel`` and ``MambaLMHeadModel``).

Embedding → n_layer × ``Block(MambaCausal)`` → final norm, and a head tied
to the embedding. ``forward`` runs whole sequences, ``prefill`` runs a
prompt and returns each layer's decode state, ``step`` advances one token.
The embedding and the mixers' in and out projections are ``W8Embed`` and
``W8Dense``: the plain modules until ``quantize_lm_for_decode`` stores
them as int8 (``models/quant_decode.py``). The MoE interleave
(``moe_every > 0``) is not ported yet.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from ..ops.norms import fused_add_norm
from .common import W8Embed, bf16_matmul_fp32, resolve_device
from .mamba import D_CONV, make_block

State = Tuple[torch.Tensor, torch.Tensor]


class MixerModel(nn.Module):
    """Embedding → n_layer pre-norm causal Mamba blocks → final norm
    (``norm_f_w``, and ``norm_f_b`` unless ``rms_norm``). Takes token ids
    and returns the final hidden states."""

    def __init__(self, d_model: int, n_layer: int, vocab_size: int,
                 d_state: int = 16, d_conv: int = D_CONV, expand: int = 2,
                 rms_norm: bool = True, residual_in_fp32: bool = True,
                 norm_eps: float = 1e-5, initializer_range: float = 0.02,
                 moe_every: int = 0, *, generator: torch.Generator):
        super().__init__()
        if moe_every:
            raise NotImplementedError(
                "the MoE interleave (moe_every > 0) is not ported yet "
                "(ROADMAP queue 1 item 10)")
        self.rms_norm, self.norm_eps = rms_norm, norm_eps
        self.embedding = W8Embed(vocab_size, d_model, generator=generator,
                                 init_std=initializer_range)
        self.layers = nn.ModuleList(
            make_block(d_model, mixer="causal", rms_norm_block=rms_norm,
                       residual_in_fp32=residual_in_fp32, norm_eps=norm_eps,
                       d_state=d_state, d_conv=d_conv, expand=expand,
                       device="cpu", generator=generator)
            for _ in range(n_layer))
        self.norm_f_w = nn.Parameter(torch.ones(d_model))
        self.norm_f_b = None if rms_norm else nn.Parameter(
            torch.zeros(d_model))

    def _final_norm(self, hidden, residual):
        hidden, _ = fused_add_norm(
            hidden, self.norm_f_w, self.norm_f_b, residual=residual,
            prenorm=False, eps=self.norm_eps, is_rms_norm=self.rms_norm)
        return hidden

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        hidden, residual = self.embedding(input_ids), None
        for layer in self.layers:
            hidden, residual = layer(hidden, residual)
        return self._final_norm(hidden, residual)

    def step(self, token: torch.Tensor, states: List[State]):
        """One token per row, (batch,) ids → (hidden (batch, d_model), new
        states)."""
        hidden, residual = self.embedding(token), None
        new_states = []
        for layer, state in zip(self.layers, states):
            hidden, residual, state = layer.step(hidden, residual, state)
            new_states.append(state)
        return self._final_norm(hidden, residual), new_states

    def prefill(self, input_ids: torch.Tensor):
        """The prompt (batch, L) in one pass → (hidden (batch, L, d_model),
        per-layer states)."""
        hidden, residual = self.embedding(input_ids), None
        states = []
        for layer in self.layers:
            hidden, residual, state = layer.prefill(hidden, residual)
            states.append(state)
        return self._final_norm(hidden, residual), states


class MambaLMHeadModel(nn.Module):
    """The Mamba LM with its head tied to the embedding: logits = hidden @
    E^T in hidden's dtype, over the vocabulary padded up to a multiple of
    ``pad_vocab_size_multiple`` (``padded_vocab``). With an int8 table the
    logits are bf16(hidden) @ bf16(E)^T in fp32 times each row's scale, in
    fp32. The residual stream is fp32, as in the JAX model."""

    def __init__(self, d_model: int, n_layer: int, vocab_size: int,
                 d_state: int = 16, d_conv: int = D_CONV, expand: int = 2,
                 rms_norm: bool = True, pad_vocab_size_multiple: int = 8,
                 moe_every: int = 0, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.d_model, self.n_layer, self.vocab_size = (d_model, n_layer,
                                                       vocab_size)
        self.pad_vocab_size_multiple = pad_vocab_size_multiple
        self.backbone = MixerModel(
            d_model, n_layer, self.padded_vocab, d_state=d_state,
            d_conv=d_conv, expand=expand, rms_norm=rms_norm,
            moe_every=moe_every, generator=generator)
        self.to(device)

    @property
    def padded_vocab(self) -> int:
        m = self.pad_vocab_size_multiple
        return -(-self.vocab_size // m) * m

    def _logits(self, hidden: torch.Tensor) -> torch.Tensor:
        embedding = self.backbone.embedding
        if embedding.qscale is not None:
            # the per-row scales become the logits' per-column scales
            return bf16_matmul_fp32(hidden, embedding.weight) \
                * embedding.qscale
        return hidden @ embedding.weight.to(hidden.dtype).t()

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """(batch, L) ids → (batch, L, padded_vocab) logits."""
        return self._logits(self.backbone(input_ids))

    def step(self, token: torch.Tensor, states: List[State]):
        """One decode step: (batch,) ids → ((batch, padded_vocab) logits,
        new states)."""
        hidden, states = self.backbone.step(token, states)
        return self._logits(hidden), states

    def prefill(self, input_ids: torch.Tensor):
        """The prompt (batch, L) in one pass → ((batch, padded_vocab)
        logits at the last prompt position, per-layer (conv_state,
        ssm_state))."""
        hidden, states = self.backbone.prefill(input_ids)
        return self._logits(hidden[:, -1]), states

    def init_states(self, batch: int) -> List[State]:
        """Each layer's zero (conv_state (batch, d_conv, d_inner),
        ssm_state (batch, d_inner, d_state)), both fp32."""
        return [layer.mixer.init_state(batch)
                for layer in self.backbone.layers]


def lm_kwargs(config: dict) -> dict:
    """``MambaLMHeadModel`` keyword arguments from an upstream
    ``state-spaces/mamba-*`` config.json dict (``d_model`` or
    ``hidden_size``, ``n_layer`` or ``num_hidden_layers``, ``vocab_size``,
    ``ssm_cfg``, ``rms_norm``, ``pad_vocab_size_multiple``; the rest is
    ignored, as the JAX loader ignores it: the residual stream is always
    fp32)."""
    ssm_cfg = config.get("ssm_cfg") or {}
    return dict(
        d_model=int(config.get("d_model", config.get("hidden_size"))),
        n_layer=int(config.get("n_layer", config.get("num_hidden_layers"))),
        vocab_size=int(config["vocab_size"]),
        d_state=int(ssm_cfg.get("d_state", 16)),
        d_conv=int(ssm_cfg.get("d_conv", D_CONV)),
        expand=int(ssm_cfg.get("expand", 2)),
        rms_norm=bool(config.get("rms_norm", True)),
        pad_vocab_size_multiple=int(config.get("pad_vocab_size_multiple",
                                               8)))


def build_mamba_lm(config: dict, device="cuda", seed: int = 0,
                   dtype: Optional[torch.dtype] = None) -> MambaLMHeadModel:
    """A Mamba LM at ``config``'s widths (for example
    ``configs.MAMBA_130M``) with random weights drawn from ``seed`` by the
    JAX package's scheme (embedding N(0, 0.02), the mixers' inits), on
    ``device`` (CUDA unless the caller asks for the CPU). ``dtype`` casts
    every floating parameter (bf16 serving)."""
    device = resolve_device(device)
    model = MambaLMHeadModel(**lm_kwargs(config), device="cpu",
                             generator=torch.Generator().manual_seed(seed))
    if dtype is not None:
        model.to(dtype)
    return model.to(device)
