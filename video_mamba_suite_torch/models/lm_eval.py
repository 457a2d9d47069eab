"""Scoring the Mamba LM: log-likelihoods, perplexity and an adapter in the
shape of an lm-evaluation-harness model (counterpart of the JAX package's
``models/lm_eval.py``).

``sequence_loglikelihood`` and ``perplexity`` take a ``MambaLMHeadModel``
(bf16, fp32 or int8 from ``quantize_lm_for_decode``) and token ids on its
device. ``MambaHarnessLM`` answers the harness's three request kinds,
``loglikelihood``, ``loglikelihood_rolling`` and ``generate_until``, with
any tokenizer that has ``encode(str) -> List[int]`` and
``decode(List[int]) -> str``; ``register()`` adds it to the harness under
the name "mamba" where the ``lm_eval`` package is installed.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from .generation import GenerationConfig, generate


def _token_logp(logits: torch.Tensor, input_ids: torch.Tensor
                ) -> torch.Tensor:
    """log p(token t | tokens < t) for t >= 1, fp32: (B, L - 1). The
    logits at t predict token t + 1."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return torch.gather(logp[:, :-1], -1, input_ids[:, 1:, None].long())[
        ..., 0]


@torch.inference_mode()
def sequence_loglikelihood(model, input_ids: torch.Tensor,
                           target_mask: torch.Tensor) -> torch.Tensor:
    """The sum of log p(token t | tokens < t) over the positions where
    ``target_mask`` (B, L) is 1, for token ids (B, L): (B,) fp32."""
    tok_logp = _token_logp(model(input_ids), input_ids)
    return torch.sum(tok_logp * target_mask[:, 1:].float(), dim=-1)


def perplexity(model, input_ids: torch.Tensor) -> float:
    """exp of the mean negative log-likelihood of every token after the
    first, over the batch (B, L)."""
    mask = torch.ones(input_ids.shape, device=input_ids.device)
    ll = sequence_loglikelihood(model, input_ids, mask)
    n_tokens = (input_ids.shape[1] - 1) * input_ids.shape[0]
    return float(torch.exp(-torch.sum(ll) / n_tokens))


def _args(request) -> tuple:
    """A harness ``Instance``'s ``args``, or the request itself."""
    return request.args if hasattr(request, "args") else request


class MambaHarnessLM:
    """The three request-level entry points of an lm-evaluation-harness
    model over a ``MambaLMHeadModel``:

      loglikelihood          (context, continuation) → (log-likelihood of
                             the continuation, whether greedy decoding
                             gives it), scored in batches of
                             ``batch_size``, each sequence cut to its last
                             ``max_length`` tokens;
      loglikelihood_rolling  (string,) → the log-likelihood of the whole
                             string after an end-of-text token;
      generate_until         (context, {"until": [...], "max_gen_toks": n})
                             → greedy text, cut at the first stop string.

    An empty context is the end-of-text token ``eot_token_id``."""

    def __init__(self, model, tokenizer, max_length: int = 2048,
                 batch_size: int = 8, eot_token_id: int = 0):
        self.model = model
        self.tokenizer = tokenizer
        self.max_length = max_length
        self.batch_size = batch_size
        self.eot_token_id = eot_token_id
        self.device = next(model.parameters()).device

    def _score(self, batch: List[Tuple[List[int], List[int]]]
               ) -> List[Tuple[float, bool]]:
        """One padded batch of (context ids, continuation ids)."""
        L = max(len(c) + len(t) for c, t in batch)
        L = min(max(L, 2), self.max_length)
        ids = np.zeros((len(batch), L), np.int64)
        mask = np.zeros((len(batch), L), np.float32)
        for i, (ctx, cont) in enumerate(batch):
            seq = (ctx + cont)[-L:]
            ids[i, :len(seq)] = seq
            n_cont = min(len(cont), L)
            mask[i, len(seq) - n_cont:len(seq)] = 1.0
        ids = torch.from_numpy(ids).to(self.device)
        mask = torch.from_numpy(mask).to(self.device)
        with torch.inference_mode():
            logits = self.model(ids)
            scored = mask[:, 1:] > 0
            lls = torch.sum(_token_logp(logits, ids) * scored, dim=-1)
            # greedy: the argmax matches the token at every scored position
            greedy = torch.argmax(logits[:, :-1], dim=-1) == ids[:, 1:]
            match = torch.where(scored, greedy, True).all(dim=-1)
        return [(float(ll), bool(g)) for ll, g in
                zip(lls.tolist(), match.tolist())]

    def loglikelihood(self, requests) -> List[Tuple[float, bool]]:
        """(log-likelihood, is_greedy) for each (context, continuation)
        request, in the requests' order."""
        out: List[Tuple[float, bool]] = []
        batch: List[Tuple[List[int], List[int]]] = []
        for request in requests:
            ctx, cont = _args(request)
            ctx_ids = (self.tokenizer.encode(ctx) if ctx
                       else [self.eot_token_id])
            batch.append((ctx_ids, self.tokenizer.encode(cont)))
            if len(batch) == self.batch_size:
                out += self._score(batch)
                batch = []
        if batch:
            out += self._score(batch)
        return out

    def loglikelihood_rolling(self, requests) -> List[float]:
        """The log-likelihood of each (string,) request, scored after the
        end-of-text token."""
        texts = [(("",) + tuple(_args(r)))[-1] for r in requests]
        return [ll for ll, _ in self.loglikelihood(
            [("", text) for text in texts])]

    def generate_until(self, requests) -> List[str]:
        """Greedy continuations of each (context, gen_kwargs) request:
        ``max_gen_toks`` new tokens (32 by default), decoded and cut
        before the first of the ``until`` strings."""
        outs = []
        for request in requests:
            ctx, kw = _args(request)
            kw = kw or {}
            max_new = int(kw.get("max_gen_toks", 32))
            ctx_ids = self.tokenizer.encode(ctx) or [self.eot_token_id]
            ids = torch.tensor([ctx_ids], device=self.device)
            config = GenerationConfig(max_length=len(ctx_ids) + max_new,
                                      top_k=1)
            tokens = generate(self.model, ids, config)
            text = self.tokenizer.decode(tokens[0, len(ctx_ids):].tolist())
            for stop in kw.get("until", []):
                idx = text.find(stop)
                if idx >= 0:
                    text = text[:idx]
            outs.append(text)
        return outs


def register() -> bool:
    """Register ``MambaHarnessLM`` with lm-evaluation-harness under the
    model name "mamba"; False when the ``lm_eval`` package is absent."""
    try:
        from lm_eval.api.registry import register_model  # type: ignore
    except ImportError:
        return False
    register_model("mamba")(MambaHarnessLM)
    return True
