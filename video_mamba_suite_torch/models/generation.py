"""Autoregressive generation for the Mamba LM (counterpart of the JAX
package's ``models/generation.py``: ``GenerationConfig``,
``sample_logits`` and ``generate``).

``generate`` runs one batched prefill over the prompt, then one ``step``
per new token, eagerly: the JAX package compiles the token loop into one
``lax.scan``, whose counterpart here (a CUDA graph of the step) is not
ported yet. The loop keeps every token on the device: it never reads one
on the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class GenerationConfig:
    max_length: int = 128      # prompt and new tokens together
    top_k: int = 1             # 1 = greedy
    top_p: float = 0.0         # 0 = off
    temperature: float = 1.0
    eos_token_id: Optional[int] = None   # carried, not used (as in JAX)


def filter_logits(logits: torch.Tensor, top_k: int = 1, top_p: float = 0.0,
                  temperature: float = 1.0) -> torch.Tensor:
    """The JAX ``sample_logits`` filter: logits / temperature, then -inf
    below the k-th largest (0 < top_k < vocab) and below the smallest
    logit whose cumulative probability, in descending order, reaches
    top_p (top_p > 0)."""
    logits = logits / max(temperature, 1e-6)
    vocab = logits.shape[-1]
    if 0 < top_k < vocab:
        kth = torch.sort(logits, dim=-1).values[..., -top_k, None]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p > 0.0:
        ordered = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(ordered, dim=-1), dim=-1)
        # at most vocab - 1: when no prefix reaches top_p every token stays
        cutoff_idx = (cum < top_p).sum(dim=-1, keepdim=True).clamp_max(
            vocab - 1)
        cutoff = torch.gather(ordered, -1, cutoff_idx)
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    return logits


def sample_logits(logits: torch.Tensor, top_k: int = 1, top_p: float = 0.0,
                  temperature: float = 1.0,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """Next tokens (batch,) from logits (batch, vocab): the argmax when
    greedy (top_k 1, top_p 0), else a draw from the filtered logits
    (``filter_logits``) by the Gumbel-max rule, as
    ``jax.random.categorical`` draws, with noise from ``generator`` (on
    the logits' device)."""
    if top_k == 1 and top_p == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = filter_logits(logits, top_k, top_p, temperature).float()
    u = torch.rand(logits.shape, device=logits.device, generator=generator)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    return torch.argmax(logits + gumbel, dim=-1)


@torch.inference_mode()
def generate(model, input_ids: torch.Tensor,
             config: GenerationConfig = GenerationConfig(),
             generator: Optional[torch.Generator] = None,
             prefill: bool = True) -> torch.Tensor:
    """Prompt ids (batch, prompt_len) → (batch, config.max_length) ids,
    the prompt included.

    prefill=True runs the prompt through ``model.prefill`` in one pass and
    then one ``model.step`` per new token; prefill=False runs the pure
    step loop from zero states, forcing the prompt's tokens. Greedy output
    is the same either way. Sampled output draws from ``generator``; it
    cannot repeat the JAX package's key stream.
    """
    batch, prompt_len = input_ids.shape
    total = config.max_length
    out = torch.empty(batch, total, dtype=input_ids.dtype,
                      device=input_ids.device)

    def sample(logits):
        return sample_logits(logits, config.top_k, config.top_p,
                             config.temperature, generator
                             ).to(input_ids.dtype)

    if not prefill:
        states = model.init_states(batch)
        token = input_ids[:, 0]
        out[:, 0] = token
        for t in range(total - 1):
            logits, states = model.step(token, states)
            token = (input_ids[:, t + 1] if t + 1 < prompt_len
                     else sample(logits))
            out[:, t + 1] = token
        return out

    genlen = total - prompt_len
    if genlen < 1:
        raise ValueError(f"max_length {total} must exceed the prompt "
                         f"length {prompt_len}")
    logits, states = model.prefill(input_ids)
    token = sample(logits)
    out[:, :prompt_len] = input_ids
    out[:, prompt_len] = token
    for t in range(prompt_len + 1, total):
        logits, states = model.step(token, states)
        token = sample(logits)
        out[:, t] = token
    return out
