"""Training PDVC-Mamba and captioning with it (the port's
``CaptioningTrainer``, counterpart of the JAX package's
``tasks/captioning/train.py``): AdamW with weight decay on every
parameter after clipping by the global norm; a step of one forward with
dropout, the matching cost from its detached outputs, the Hungarian
assignment on the host, the losses on that same forward and the
backward, so that the matching comes from the forward the gradient sees;
and ``predict``'s ranked events with greedy captions.

    trainer = build_captioning_trainer(configs.DVC_ANET_C3D, vocab_size)
    losses = trainer.train_step(*collate_captioning(items, 256))
    events = trainer.predict(feats, mask, duration, vocab=vocab_list(tok))

At the ActivityNet preset's 256 features the encoder scans 256 + 128 +
64 + 32 = 480 tokens: 2 layers x 2 directions of K3 on the card (with
checkpoints when a backward follows) and as many K4 in the backward.
``save`` / ``restore`` checkpoint the trainer's whole state.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ...utils.optim import make_optimizer
from ...utils.trainer import (
    Checkpointing,
    TrainerCore,
    load_generator_state,
)
from .criterion import pdvc_losses
from .matcher import hungarian_match, match_cost
from .model import PDVC


class CaptioningTrainer(Checkpointing):
    """The JAX ``CaptioningTrainer`` around a built ``PDVC``: AdamW at
    ``lr`` with ``weight_decay`` on every parameter (the JAX optimizer
    gets no mask), the gradients clipped to a global norm of
    ``grad_clip``; the dropouts draw from a generator on the model's
    device seeded with ``seed``. ``max_seq_len`` and ``max_events`` are
    the padding of its batches (``collate_captioning``). ``use_mesh``
    raises, as ``TrainerCore`` does."""

    def __init__(self, model: PDVC, lr: float = 5e-5,
                 weight_decay: float = 1e-4, grad_clip: float = 0.1,
                 seed: int = 0, use_mesh: bool = False,
                 max_seq_len: int = 256, max_events: int = 10):
        self.model = model
        self.device = next(model.parameters()).device
        self.core = TrainerCore(use_mesh=use_mesh, device=self.device)
        self.max_seq_len, self.max_events = max_seq_len, max_events
        self.optimizer = make_optimizer(model, "adamw", lr=lr,
                                        weight_decay=weight_decay,
                                        grad_clip=grad_clip)
        self.generator = torch.Generator(device=self.device).manual_seed(
            seed)

    def state_dict(self):
        return dict(params=self.model.state_dict(),
                    opt_state=self.optimizer.state_dict(),
                    generator=self.generator.get_state())

    def load_state_dict(self, state):
        self.model.load_state_dict(state["params"])
        self.optimizer.load_state_dict(state["opt_state"])
        load_generator_state(self.generator, state["generator"])

    def _on(self, x, dtype) -> torch.Tensor:
        return torch.as_tensor(x).to(self.device, dtype)

    def _caption_kwargs(self, out, idx, T):
        """The "standard" head's refs, memory rows and level lengths for
        the queries ``idx`` (B, N) of each video."""
        if self.model.caption_decoder_type != "standard":
            return {}
        B, N = idx.shape
        boxes = out["pred_boxes"].gather(1, idx[..., None].expand(B, N, 2))
        return dict(refs=boxes.reshape(B * N, 2),
                    memory=out["memory"].repeat_interleave(N, dim=0),
                    shapes=self.model.level_shapes(T))

    def matched_caption_logits(self, out: Dict, captions, match_idx, T
                               ) -> torch.Tensor:
        """Teacher-forced caption logits (B, G, L, vocab) of each event
        from its matched query's features (an unmatched or invalid event
        through query 0); -100 padding enters as token 0. ``T`` is the
        padded length of the features."""
        qf = out["query_feats"]
        safe_idx = match_idx.clamp(0, qf.shape[1] - 1)
        B, G, L = captions.shape
        feat = qf.gather(1, safe_idx[..., None].expand(B, G, qf.shape[-1]))
        cap_in = torch.where(captions == -100, 0, captions)
        return self.model.caption_logits(
            feat.reshape(B * G, -1), cap_in.reshape(B * G, L),
            **self._caption_kwargs(out, safe_idx, T)).reshape(B, G, L, -1)

    def losses(self, out: Dict, feats, gt_boxes, gt_labels, gt_valid,
               captions, match_idx) -> Dict[str, torch.Tensor]:
        """``pdvc_losses`` of a forward's outputs under ``match_idx`` (B,
        G), with ``matched_caption_logits`` (masked to the matched valid
        events by the criterion): logits at t predict the token at
        t + 1."""
        if self.model.caption_decoder_type == "none":
            return pdvc_losses(out, gt_boxes, gt_labels, gt_valid, match_idx)
        cap_logits = self.matched_caption_logits(out, captions, match_idx,
                                                 feats.shape[1])
        return pdvc_losses(out, gt_boxes, gt_labels, gt_valid, match_idx,
                           caption_logits=cap_logits[:, :, :-1],
                           caption_targets=captions[:, :, 1:])

    def train_step(self, feats, mask, gt_boxes, gt_labels, gt_valid,
                   captions, deterministic: bool = False
                   ) -> Dict[str, float]:
        """One step on a ``collate_captioning`` batch (numpy arrays or
        tensors): the forward with dropout (none with
        ``deterministic``), the matching, the losses, the backward and
        the update of every parameter (a zero gradient where the loss
        does not reach, which still decays, as under optax). Returns the
        losses before the update, read from the device once."""
        n_valid = torch.as_tensor(gt_valid).sum(dim=1).cpu().numpy()
        feats = self._on(feats, torch.float32)
        mask = self._on(mask, torch.float32)
        gt_boxes = self._on(gt_boxes, torch.float32)
        gt_labels = self._on(gt_labels, torch.long)
        gt_valid = self._on(gt_valid, torch.bool)
        captions = self._on(captions, torch.long)
        self.model.train(not deterministic)
        out = self.model(feats, mask, generator=None if deterministic
                         else self.generator)
        cost = match_cost(out["pred_logits"].detach(),
                          out["pred_boxes"].detach(), gt_labels, gt_boxes,
                          gt_valid)
        match_idx = hungarian_match(cost, n_valid)
        losses = self.losses(out, feats, gt_boxes, gt_labels, gt_valid,
                             captions, match_idx)
        self.optimizer.zero_grad(set_to_none=True)
        losses["loss_total"].backward()
        for p in self.model.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.optimizer.step()
        values = torch.stack([v.detach() for v in losses.values()]).cpu()
        return dict(zip(losses, values.tolist()))

    @torch.inference_mode()
    def forward_captions(self, feats, mask):
        """The eval forward and greedy captions of every query: (outputs,
        tokens (B, Q, max_caption_len), their log-probs), on the
        device."""
        model = self.model
        model.eval()
        feats = self._on(feats, torch.float32)
        out = model(feats, self._on(mask, torch.float32))
        B, Q, C = out["query_feats"].shape
        L = model.max_caption_len
        if model.caption_decoder_type == "none":
            # proposals only: empty captions, zero scores
            return (out, torch.zeros(B, Q, L, dtype=torch.long,
                                     device=self.device),
                    torch.zeros(B, Q, L, device=self.device))
        idx = torch.arange(Q, device=self.device).expand(B, Q)
        caps, lps = model.caption_greedy(
            out["query_feats"].reshape(B * Q, C),
            **self._caption_kwargs(out, idx, feats.shape[1]))
        return out, caps.reshape(B, Q, -1), lps.reshape(B, Q, -1)

    def predict(self, feats, mask, duration: float, topk: int = 10,
                vocab: Optional[List[str]] = None) -> List[List[dict]]:
        """Each video's ``topk`` events by class probability: timestamp
        (seconds of ``duration``), sentence (the greedy tokens up to the
        first 0, as words of ``vocab`` or as numbers), score and
        proposal_score (the probability), sentence_score (the sum of the
        words' log-probs) and pred_event_count (the count head's
        argmax)."""
        out, caps, cap_lps = self.forward_captions(feats, mask)
        probs = torch.sigmoid(out["pred_logits"]).amax(dim=-1)
        counts = torch.argmax(out["pred_count"], dim=-1)
        probs, boxes, counts, caps, cap_lps = (
            t.cpu().numpy() for t in (probs, out["pred_boxes"], counts,
                                      caps, cap_lps))
        results = []
        for b in range(probs.shape[0]):
            order = np.argsort(-probs[b])[:topk]
            events = []
            for q in order:
                c, l = boxes[b, q]
                start, end = (c - l / 2) * duration, (c + l / 2) * duration
                words, sent_lp = [], 0.0
                for i, t in enumerate(caps[b, q]):
                    if t == 0:
                        break
                    words.append(vocab[t] if vocab else str(int(t)))
                    sent_lp += float(cap_lps[b, q, i])
                events.append(dict(
                    timestamp=[float(start), float(end)],
                    sentence=" ".join(words),
                    score=float(probs[b, q]),
                    proposal_score=float(probs[b, q]),
                    sentence_score=sent_lp,
                    pred_event_count=int(counts[b]),
                ))
            results.append(events)
        return results


# the JAX CLI's defaults where a preset names no value (cli.py:393-425)
_DEFAULTS = dict(max_seq_len=256, max_events=10, max_caption_len=20,
                 num_queries=100, num_decoder_layers=6, d_model=512,
                 n_levels=4, num_encoder_layers=2, max_eseq_length=10,
                 mixer="vim", caption_decoder_type="light", num_classes=1)
_MODEL_KEYS = ("input_dim", "num_classes", "num_queries", "d_model",
               "n_levels", "num_encoder_layers", "num_decoder_layers",
               "max_eseq_length", "max_caption_len", "mixer",
               "caption_decoder_type")


def captioning_trainer_kwargs(config: dict) -> dict:
    """A dense-captioning preset of ``configs`` read as ``build_vtg_trainer``
    reads its presets: each value from ``dataset`` first, then ``model``,
    then the JAX CLI's default (max_seq_len 256, max_events 10,
    max_caption_len 20, num_queries 100, num_decoder_layers 6, d_model
    512, 4 levels, 2 encoder layers); the learning rate from ``opt``.
    Weight decay and clipping are the trainer's defaults (1e-4, 0.1), as
    the JAX CLI leaves them."""
    d, m = config.get("dataset", {}), config.get("model", {})

    def read(key):
        return d.get(key, m.get(key, _DEFAULTS.get(key)))

    kw = {k: read(k) for k in _MODEL_KEYS + ("max_seq_len", "max_events")}
    kw["lr"] = config["opt"]["learning_rate"]
    return kw


def build_captioning_trainer(config: dict, vocab_size: int, device="cuda",
                             seed: int = 0, **overrides
                             ) -> CaptioningTrainer:
    """A ``CaptioningTrainer`` around a ``PDVC`` built from a
    dense-captioning configuration of ``configs`` (``DVC_ANET_C3D`` or
    ``DVC_YC2_TSN``; ``captioning_trainer_kwargs``) with a vocabulary of
    ``vocab_size`` (the tokenizer's). Random weights from ``seed``;
    ``overrides`` change any ``PDVC`` or ``CaptioningTrainer``
    argument."""
    kw = dict(captioning_trainer_kwargs(config), **overrides)
    model_kw = {k: kw.pop(k) for k in _MODEL_KEYS}
    model = PDVC(vocab_size=vocab_size, device=device, seed=seed, **model_kw)
    return CaptioningTrainer(model, seed=seed, **kw)
