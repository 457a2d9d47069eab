"""PDVC-Mamba, the dense video captioner (the port's counterpart of the JAX
package's ``tasks/captioning/model.py``): an input projection and a
stride-2 conv pyramid of ``n_levels`` levels, a Mamba encoder over the
flattened multi-scale tokens, a deformable decoder whose event queries
refine their reference centers layer by layer, the class, count and box
heads, and a caption head: the plain LSTM ("light") or the LSTM with
deformable sampling around the event and additive attention
("standard", LSTM-DSA), or none.

The encoder's ViM (or DBM) mixers scan the ΣT_l tokens in one sequence:
above 64 steps one chunked scan per direction, K3 on the card (K4 in the
backward), at 64 or fewer the fused scan, K1 (K2). The rest is plain
torch: the deformable sampling is a gather (the JAX package has no
kernel for it either), the decoder's query self-attention a matmul and a
softmax.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...models.common import (
    Dense,
    Embedding,
    LayerNorm,
    dropout,
    init_weight,
    resolve_device,
    sinusoid_positions,
)
from ...models.mamba import MambaDBM, MambaVim
from ...ops.deform_attn import (
    MSDeformAttn1D,
    directional_offset_bias,
    linear_sample_1d,
)


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x = x.clamp(eps, 1 - eps)
    return torch.log(x / (1 - x))


def pdvc_level_shapes(T: int, n_levels: int) -> Tuple[int, ...]:
    """The lengths of the conv pyramid's levels: T, then ceil(T / 2) each
    level (flax's SAME padding at stride 2)."""
    shapes = [T]
    for _ in range(n_levels - 1):
        shapes.append(-(-shapes[-1] // 2))
    return tuple(shapes)


class FFN(nn.Module):
    """``linear1`` → ReLU → dropout → ``linear2`` → dropout, added to the
    input, then LayerNorm ``norm``."""

    def __init__(self, d_ffn: int, d_model: int, rate: float = 0.1, *,
                 generator: torch.Generator):
        super().__init__()
        self.rate = rate
        self.linear1 = Dense(d_model, d_ffn, generator=generator)
        self.linear2 = Dense(d_ffn, d_model, generator=generator)
        self.norm = LayerNorm(d_model)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = F.relu(self.linear1(x))
        h = dropout(h, self.rate, self.training, generator)
        h = dropout(self.linear2(h), self.rate, self.training, generator)
        return self.norm(x + h)


class MambaEncoderLayer(nn.Module):
    """The mixer (``MambaVim``, or ``MambaDBM`` with expand 1 for
    ``mixer="dbm"``) on src + pos under the mask, dropout, LayerNorm
    ``norm1`` of the residual sum, then ``ffn``."""

    def __init__(self, d_model: int, d_ffn: int = 1024, rate: float = 0.1,
                 mixer: str = "vim", *, generator: torch.Generator):
        super().__init__()
        if mixer not in ("vim", "dbm"):
            raise ValueError(f"unknown mixer {mixer!r}")
        self.rate = rate
        if mixer == "vim":
            self.mamba = MambaVim(d_model, device="cpu", generator=generator)
        else:
            self.mamba = MambaDBM(d_model, expand=1, device="cpu",
                                  generator=generator)
        self.norm1 = LayerNorm(d_model)
        self.ffn = FFN(d_ffn, d_model, rate, generator=generator)

    def forward(self, src, pos, mask, generator=None):
        h = self.mamba(src + pos, mask)
        h = dropout(h, self.rate, self.training, generator)
        src = self.norm1(src + h)
        return self.ffn(src, generator)


class QueryAttention(nn.Module):
    """flax ``nn.MultiHeadDotProductAttention`` as the decoder calls it:
    ``query``, ``key``, ``value`` and ``out`` projections with biases
    (weights (H·dh, d) and (d, H·dh), heads major), queries scaled by
    1/√dh, a softmax over all keys, no mask and no attention dropout."""

    def __init__(self, d_model: int, n_heads: int, *,
                 generator: torch.Generator):
        super().__init__()
        self.n_heads = n_heads
        self.query = Dense(d_model, d_model, generator=generator)
        self.key = Dense(d_model, d_model, generator=generator)
        self.value = Dense(d_model, d_model, generator=generator)
        self.out = Dense(d_model, d_model, generator=generator)

    def forward(self, inputs_q, inputs_k, inputs_v):
        B, Q, _ = inputs_q.shape
        H = self.n_heads

        def heads(x):
            return x.reshape(B, x.shape[1], H, -1)

        q, k, v = (heads(self.query(inputs_q)), heads(self.key(inputs_k)),
                   heads(self.value(inputs_v)))
        q = q / math.sqrt(q.shape[-1])
        weights = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), -1)
        out = torch.einsum("bhqk,bkhd->bqhd", weights, v)
        return self.out(out.reshape(B, Q, -1))


class DeformableDecoderLayer(nn.Module):
    """Query self-attention (query and key from tgt + query_pos, the value
    from tgt) → dropout → ``norm2``; deformable cross-attention into the
    encoder's memory around the reference points → dropout → ``norm1``;
    then ``ffn``."""

    def __init__(self, d_model: int, d_ffn: int = 1024, n_heads: int = 8,
                 n_levels: int = 4, n_points: int = 4, rate: float = 0.1,
                 *, generator: torch.Generator):
        super().__init__()
        self.rate = rate
        self.self_attn = QueryAttention(d_model, n_heads, generator=generator)
        self.norm2 = LayerNorm(d_model)
        self.cross_attn = MSDeformAttn1D(d_model, n_levels, n_heads,
                                         n_points, generator=generator)
        self.norm1 = LayerNorm(d_model)
        self.ffn = FFN(d_ffn, d_model, rate, generator=generator)

    def forward(self, tgt, query_pos, reference_points, src,
                temporal_shapes, src_padding_mask=None, generator=None):
        q = tgt + query_pos
        att = self.self_attn(q, q, tgt)
        tgt = self.norm2(tgt + dropout(att, self.rate, self.training,
                                       generator))
        cross = self.cross_attn(tgt + query_pos, reference_points, src,
                                temporal_shapes, src_padding_mask)
        tgt = self.norm1(tgt + dropout(cross, self.rate, self.training,
                                       generator))
        return self.ffn(tgt, generator)


class BoxMLP(nn.Module):
    """Three Dense layers ``l0``, ``l1``, ``l2`` with ReLUs between →
    (center offset, log-length); ``l2``'s weight zero, its bias (0, −2)."""

    def __init__(self, d_model: int, *, generator: torch.Generator):
        super().__init__()
        self.l0 = Dense(d_model, d_model, generator=generator)
        self.l1 = Dense(d_model, d_model, generator=generator)
        self.l2 = Dense(d_model, 2, generator=generator)
        with torch.no_grad():
            self.l2.weight.zero_()
            self.l2.bias.copy_(torch.tensor([0.0, -2.0]))

    def forward(self, x):
        return self.l2(F.relu(self.l1(F.relu(self.l0(x)))))


class DeformableTransformer(nn.Module):
    """The Mamba encoder over the flattened multi-scale tokens and the
    deformable decoder with iterative reference refinement. ``forward``
    returns (the decoder's output per layer, the refined centers per
    layer, the memory (B, ΣT_l, C), the level lengths). Between layers
    the centers are detached; the ones returned are not."""

    def __init__(self, d_model: int = 256, n_heads: int = 8,
                 num_encoder_layers: int = 2, num_decoder_layers: int = 2,
                 d_ffn: int = 1024, n_levels: int = 4, n_points: int = 4,
                 rate: float = 0.1, mixer: str = "vim", *,
                 generator: torch.Generator):
        super().__init__()
        self.n_levels = n_levels
        self.level_embed = nn.Parameter(torch.randn(
            n_levels, d_model, generator=generator))
        self.enc = nn.ModuleList(
            MambaEncoderLayer(d_model, d_ffn, rate, mixer,
                              generator=generator)
            for _ in range(num_encoder_layers))
        self.reference_points = Dense(d_model, 1, generator=generator)
        self.dec = nn.ModuleList(
            DeformableDecoderLayer(d_model, d_ffn, n_heads, n_levels,
                                   n_points, rate, generator=generator)
            for _ in range(num_decoder_layers))
        self.refine = nn.ModuleList(
            BoxMLP(d_model, generator=generator)
            for _ in range(num_decoder_layers))

    def forward(self, srcs: List[torch.Tensor], masks: List[torch.Tensor],
                pos_embeds: List[torch.Tensor], query_embed: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        temporal_shapes = [s.shape[1] for s in srcs]
        src_flat = torch.cat(srcs, dim=1)
        mask_flat = torch.cat(masks, dim=1)
        pos_flat = torch.cat([p + self.level_embed[l][None, None]
                              for l, p in enumerate(pos_embeds)], dim=1)
        memory = src_flat
        for layer in self.enc:
            memory = layer(memory, pos_flat, mask_flat, generator)

        B = src_flat.shape[0]
        query_pos, tgt = torch.chunk(query_embed, 2, dim=-1)
        query_pos = query_pos[None].expand(B, -1, -1).to(memory.dtype)
        tgt = tgt[None].expand(B, -1, -1).to(memory.dtype)
        ref = torch.sigmoid(self.reference_points(query_pos))   # (B, Q, 1)
        hs_layers, ref_layers = [], []
        padding = mask_flat < 0.5
        for layer, refine in zip(self.dec, self.refine):
            ref_input = ref[:, :, None, :].expand(-1, -1, self.n_levels, -1)
            tgt = layer(tgt, query_pos, ref_input, memory, temporal_shapes,
                        padding, generator)
            delta = refine(tgt)
            new_center = torch.sigmoid(delta[..., :1] + inverse_sigmoid(ref))
            ref = new_center.detach()
            hs_layers.append(tgt)
            ref_layers.append(new_center)
        return hs_layers, ref_layers, memory, temporal_shapes


def _orthogonal(n: int, generator: torch.Generator) -> torch.Tensor:
    return nn.init.orthogonal_(torch.empty(n, n), generator=generator)


class LSTMCell(nn.Module):
    """flax ``nn.OptimizedLSTMCell``: gates (i, f, g, o) from the input
    through ``weight_ih`` (4H, in), no bias, plus the hidden state through
    ``weight_hh`` (4H, H) and ``bias_hh``; c' = f·c + i·g, h' =
    o·tanh(c'). The carry is (c, h). Initial weights as flax draws them:
    lecun normal input kernels, orthogonal recurrent kernels (one per
    gate), zero bias."""

    def __init__(self, in_features: int, hidden: int, *,
                 generator: torch.Generator):
        super().__init__()
        self.weight_ih = nn.Parameter(torch.cat([
            init_weight((hidden, in_features), "lecun_normal", generator,
                        fan_in=in_features) for _ in range(4)]))
        self.weight_hh = nn.Parameter(torch.cat([
            _orthogonal(hidden, generator) for _ in range(4)]))
        self.bias_hh = nn.Parameter(torch.zeros(4 * hidden))

    def forward(self, carry, x):
        c, h = carry
        z = F.linear(h, self.weight_hh, self.bias_hh) + F.linear(
            x, self.weight_ih)
        i, f, g, o = z.chunk(4, dim=-1)
        new_c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        new_h = torch.sigmoid(o) * torch.tanh(new_c)
        return (new_c, new_h), new_h


def _word_embed(vocab_size: int, word_dim: int, generator) -> Embedding:
    """flax ``nn.Embed``'s init: N(0, 1 / word_dim)."""
    return Embedding(vocab_size, word_dim, generator=generator,
                     init_std=word_dim ** -0.5)


def _greedy_step(logits: torch.Tensor):
    """(the argmax token, its log-probability in fp32)."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    tok = torch.argmax(logits, dim=-1)
    return tok, lp.gather(-1, tok[:, None])[:, 0]


class LSTMCaptioner(nn.Module):
    """The plain LSTM caption head ("light"): the cell starts from c = 0,
    h = ``feat_proj``(event feature) and reads the words; ``logit`` gives
    the next-token logits."""

    def __init__(self, vocab_size: int, d_model: int = 256,
                 word_dim: int = 256, hidden_dim: int = 512,
                 max_caption_len: int = 20, *, generator: torch.Generator):
        super().__init__()
        self.max_caption_len = max_caption_len
        self.word_embed = _word_embed(vocab_size, word_dim, generator)
        self.cell = LSTMCell(word_dim, hidden_dim, generator=generator)
        self.logit = Dense(hidden_dim, vocab_size, generator=generator)
        self.feat_proj = Dense(d_model, hidden_dim, generator=generator)

    def forward(self, event_feats: torch.Tensor,
                captions: torch.Tensor) -> torch.Tensor:
        """Teacher-forced logits: event_feats (N, C), captions (N, L) →
        (N, L, vocab)."""
        feat = self.feat_proj(event_feats)
        carry = (torch.zeros_like(feat), feat)
        words = self.word_embed(captions)
        outs = []
        for t in range(captions.shape[1]):
            carry, out = self.cell(carry, words[:, t])
            outs.append(out)
        return self.logit(torch.stack(outs, dim=1))

    def decode_greedy(self, event_feats: torch.Tensor, bos: int = 0):
        """Greedy decode from ``bos`` → ((N, max_caption_len) token ids,
        (N, max_caption_len) log-probabilities of the chosen tokens)."""
        feat = self.feat_proj(event_feats)
        carry = (torch.zeros_like(feat), feat)
        tok = torch.full((feat.shape[0],), bos, dtype=torch.long,
                         device=feat.device)
        toks, lps = [], []
        for _ in range(self.max_caption_len):
            carry, out = self.cell(carry, self.word_embed(tok))
            tok, lp = _greedy_step(self.logit(out))
            toks.append(tok)
            lps.append(lp)
        return torch.stack(toks, dim=1), torch.stack(lps, dim=1)


class DSACaptioner(nn.Module):
    """The LSTM-DSA caption head ("standard"). Each step, [h; query]
    gives each head's sampling offsets around the event's (center,
    length) box; the L·P features sampled from the encoder memory
    (projected by ``value_proj``) are pooled by additive attention on h
    (``ctx2att``, ``h2att``, ``alpha_net``); [word; pooled; query] feeds
    the cell, which starts from zeros."""

    def __init__(self, vocab_size: int, d_model: int = 256,
                 word_dim: int = 256, rnn_size: int = 512,
                 att_hid: int = 512, n_levels: int = 4, n_heads: int = 8,
                 n_points: int = 4, max_caption_len: int = 20, *,
                 generator: torch.Generator):
        super().__init__()
        self.d_model, self.rnn_size = d_model, rnn_size
        self.n_levels, self.n_heads, self.n_points = (n_levels, n_heads,
                                                      n_points)
        self.max_caption_len = max_caption_len
        hlp = n_heads * n_levels * n_points
        self.word_embed = _word_embed(vocab_size, word_dim, generator)
        self.cell = LSTMCell(word_dim + 2 * d_model, rnn_size,
                             generator=generator)
        self.logit = Dense(rnn_size, vocab_size, generator=generator)
        self.value_proj = Dense(d_model, d_model, generator=generator)
        self.sampling_offsets = Dense(rnn_size + d_model, hlp,
                                      generator=generator)
        with torch.no_grad():
            self.sampling_offsets.weight.zero_()
            self.sampling_offsets.bias.copy_(
                directional_offset_bias(n_heads, n_levels, n_points))
        self.ctx2att = Dense(d_model // n_heads, att_hid, generator=generator)
        self.h2att = Dense(rnn_size, att_hid, generator=generator)
        self.alpha_net = Dense(att_hid, 1, generator=generator)

    def _levels(self, memory: torch.Tensor, shapes: Sequence[int]):
        """The projected memory of each level as (N·H, T_l, dh) rows: the
        same for every step of a call."""
        N, S, _ = memory.shape
        H = self.n_heads
        value = self.value_proj(memory).reshape(N, S, H, -1)
        levels, start = [], 0
        for T in shapes:
            v = value[:, start:start + T].permute(0, 2, 1, 3)
            levels.append(v.reshape(N * H, T, -1))
            start += T
        return levels

    def _pool(self, h, query, refs, levels):
        """h (N, R), query (N, C), refs (N, 2) → the pooled (N, C)."""
        N = query.shape[0]
        H, L, P = self.n_heads, self.n_levels, self.n_points
        offsets = self.sampling_offsets(torch.cat([h, query], dim=-1))
        offsets = offsets.reshape(N, H, L, P)
        loc = (refs[:, None, None, None, 0]
               + offsets / P * refs[:, None, None, None, 1] * 0.5)
        sampled = torch.cat([
            linear_sample_1d(v, loc[:, :, l].reshape(N * H, 1, P)).reshape(
                N, H, P, -1)
            for l, v in enumerate(levels)], dim=2)          # (N, H, L·P, dh)
        att = torch.tanh(self.ctx2att(sampled)
                         + self.h2att(h)[:, None, None])
        w = torch.softmax(self.alpha_net(att)[..., 0], dim=-1)
        pooled = (sampled * w[..., None]).sum(dim=2)
        return pooled.reshape(N, self.d_model)

    def _zeros(self, query):
        z = query.new_zeros(query.shape[0], self.rnn_size)
        return (z, z)

    def forward(self, query_feats, captions, refs, memory, shapes):
        """Teacher-forced logits. query_feats (N, C), captions (N, L), refs
        (N, 2), memory (N, ΣT_l, C) (each event's row of the encoder
        memory), shapes the level lengths → (N, L, vocab)."""
        levels = self._levels(memory, shapes)
        carry = self._zeros(query_feats)
        words = self.word_embed(captions)
        outs = []
        for t in range(captions.shape[1]):
            pooled = self._pool(carry[1], query_feats, refs, levels)
            inp = torch.cat([words[:, t], pooled, query_feats], dim=-1)
            carry, out = self.cell(carry, inp)
            outs.append(out)
        return self.logit(torch.stack(outs, dim=1))

    def decode_greedy(self, query_feats, refs, memory, shapes,
                      bos: int = 0):
        levels = self._levels(memory, shapes)
        carry = self._zeros(query_feats)
        tok = torch.full((query_feats.shape[0],), bos, dtype=torch.long,
                         device=query_feats.device)
        toks, lps = [], []
        for _ in range(self.max_caption_len):
            pooled = self._pool(carry[1], query_feats, refs, levels)
            inp = torch.cat([self.word_embed(tok), pooled, query_feats], -1)
            carry, out = self.cell(carry, inp)
            tok, lp = _greedy_step(self.logit(out))
            toks.append(tok)
            lps.append(lp)
        return torch.stack(toks, dim=1), torch.stack(lps, dim=1)


class SameConv1d(nn.Module):
    """flax ``nn.Conv`` over time with SAME padding: out = ceil(T /
    stride), the padding split with the smaller half on the left (at
    stride 2 and an even T: 0 left, 1 right). ``weight`` (out, in, k),
    ``bias``; initial weight lecun normal."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: int = 3, stride: int = 2, *,
                 generator: torch.Generator):
        super().__init__()
        self.kernel_size, self.stride = kernel_size, stride
        self.weight = nn.Parameter(init_weight(
            (features, in_features, kernel_size), "lecun_normal", generator,
            fan_in=kernel_size * in_features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, C) → (B, ceil(T / stride), features)."""
        T = x.shape[1]
        out = -(-T // self.stride)
        pad = max((out - 1) * self.stride + self.kernel_size - T, 0)
        x = F.pad(x.transpose(1, 2), (pad // 2, pad - pad // 2))
        y = F.conv1d(x, self.weight.to(x.dtype), self.bias.to(x.dtype),
                     stride=self.stride)
        return y.transpose(1, 2)


class PDVC(nn.Module):
    """The JAX ``PDVC``. ``forward(feats (B, T, C), mask (B, T) 1 at valid
    steps)`` returns pred_logits (B, Q, num_classes), pred_boxes (B, Q, 2)
    (center, length), pred_count (B, max_eseq_length + 1) of the last
    decoder layer, aux_outputs (the same of the layers before), the last
    layer's query_feats (B, Q, C) and the encoder's memory (B, ΣT_l, C).
    ``caption_logits`` and ``caption_greedy`` run the caption head. In
    training mode the dropouts draw from ``generator``. Builds on
    ``device``, CUDA unless the caller passes "cpu"; initial weights from
    ``seed``."""

    def __init__(self, input_dim: int, num_classes: int = 1,
                 vocab_size: int = 100, num_queries: int = 10,
                 d_model: int = 256, n_levels: int = 4,
                 num_encoder_layers: int = 2, num_decoder_layers: int = 2,
                 max_eseq_length: int = 10, max_caption_len: int = 20,
                 mixer: str = "vim", caption_decoder_type: str = "light",
                 device="cuda", seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        if caption_decoder_type not in ("light", "standard", "none"):
            raise ValueError(f"unknown caption_decoder_type "
                             f"{caption_decoder_type!r}")
        g = torch.Generator().manual_seed(seed)
        self.d_model, self.n_levels = d_model, n_levels
        self.max_caption_len = max_caption_len
        self.caption_decoder_type = caption_decoder_type
        self.input_proj = Dense(input_dim, d_model, generator=g)
        self.level_convs = nn.ModuleList(
            SameConv1d(d_model, d_model, generator=g)
            for _ in range(n_levels - 1))
        self.transformer = DeformableTransformer(
            d_model=d_model, n_levels=n_levels,
            num_encoder_layers=num_encoder_layers,
            num_decoder_layers=num_decoder_layers, mixer=mixer, generator=g)
        self.query_embed = nn.Parameter(torch.randn(
            num_queries, 2 * d_model, generator=g))
        self.class_head = Dense(d_model, num_classes, generator=g)
        with torch.no_grad():
            self.class_head.bias.fill_(-math.log((1 - 0.01) / 0.01))
        self.count_head = Dense(d_model, max_eseq_length + 1, generator=g)
        self.bbox_head = BoxMLP(d_model, generator=g)
        if caption_decoder_type == "standard":
            self.caption_head = DSACaptioner(
                vocab_size, d_model=d_model, n_levels=n_levels,
                max_caption_len=max_caption_len, generator=g)
        elif caption_decoder_type == "light":
            self.caption_head = LSTMCaptioner(
                vocab_size, d_model=d_model,
                max_caption_len=max_caption_len, generator=g)
        else:                        # proposals only
            self.caption_head = None
        self.to(device)

    def _features(self, feats, mask):
        """The level tokens, their masks and sinusoid positions."""
        x = self.input_proj(feats)
        srcs, masks = [x], [mask]
        m = mask
        for conv in self.level_convs:
            x = conv(x)
            m = m[:, ::2][:, :x.shape[1]]
            srcs.append(x)
            masks.append(m)
        poss = [sinusoid_positions(s.shape[1], self.d_model,
                                   device=s.device)[None].to(s.dtype)
                for s in srcs]
        return srcs, masks, poss

    def forward(self, feats: torch.Tensor, mask: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> Dict:
        srcs, masks, poss = self._features(feats, mask)
        hs, refs, memory, _ = self.transformer(srcs, masks, poss,
                                               self.query_embed, generator)
        outs = []
        for h, r in zip(hs, refs):
            box = self.bbox_head(h)
            center = torch.sigmoid(box[..., :1] + inverse_sigmoid(r))
            length = torch.sigmoid(box[..., 1:])
            outs.append(dict(
                pred_logits=self.class_head(h),
                pred_boxes=torch.cat([center, length], dim=-1),
                pred_count=self.count_head(h.max(dim=1).values)))
        out = outs[-1]
        out["aux_outputs"] = outs[:-1]
        out["query_feats"] = hs[-1]
        out["memory"] = memory
        return out

    def level_shapes(self, T: int) -> Tuple[int, ...]:
        return pdvc_level_shapes(T, self.n_levels)

    def caption_logits(self, query_feats, captions, refs=None, memory=None,
                       shapes=None) -> torch.Tensor:
        """Teacher-forced caption logits of events: query_feats (N, C),
        captions (N, L); the "standard" head also takes refs (N, 2), each
        event's memory row (N, ΣT_l, C) and the level lengths."""
        if self.caption_decoder_type == "standard":
            return self.caption_head(query_feats, captions, refs, memory,
                                     shapes)
        return self.caption_head(query_feats, captions)

    def caption_greedy(self, query_feats, refs=None, memory=None,
                       shapes=None):
        """Greedy captions from token 0: (tokens, their log-probs), each
        (N, max_caption_len)."""
        if self.caption_decoder_type == "standard":
            return self.caption_head.decode_greedy(query_feats, refs, memory,
                                                   shapes)
        return self.caption_head.decode_greedy(query_feats)
