"""ASFormer-Mamba for temporal action segmentation (the port's
``MaTransformer``, counterpart of the JAX package's ``tasks/tas/model.py``).

    encoder: conv 1x1 → N × MambaAttModule (dilated conv feed-forward →
             masked instance norm → MaskMambaBlock, α·out + feed-forward,
             residual) → conv 1x1 to the classes
    decoder: conv 1x1 → N × AttnAttModule (feed-forward → instance norm →
             sliding-window cross attention, queries and keys from the
             decoder, values from the encoder's features) → conv 1x1
    MaTransformer: the encoder, then ``num_decoders`` decoders, each on the
             softmax of the stage before it, α = e^(−3s) at decoder s

Layout (B, L, C); masks (B, L) floats. Conv weights are torch's (out, in,
k) with a bias, drawn by flax's default Conv init (lecun normal, zero
bias). Above 64 steps each encoder layer's ViM mixer runs one chunked scan
per direction (kernel K3 on the card, K4 in the backward), up to 64 the
fused bidirectional scan (K1, K2). In training mode the dropouts (0.5 in
every layer, whole channels at the input at ``channel_masking_rate``)
and the drop-paths (``drop_path_rate``) draw their masks from the
generator passed to ``forward``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...models.common import (
    MaskMambaBlock,
    dropout,
    init_weight,
    instance_norm_1d,
    resolve_device,
    sliding_window_attention,
)

LAYER_DROPOUT = 0.5                     # both attention modules' dropout


def exponential_descrease(idx_decoder: int, p: float = 3.0) -> float:
    """α of decoder ``idx_decoder``: e^(−p·idx) (upstream's name)."""
    return math.exp(-p * idx_decoder)


class Conv1d(nn.Module):
    """flax ``nn.Conv`` over time on (B, L, C) with ``dilation`` and
    ``dilation`` steps of zero padding on each side (a width-3 kernel
    keeps the length); a width-1 kernel is a matmul."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 1,
                 dilation: int = 1, *, generator: torch.Generator):
        super().__init__()
        self.dilation = dilation
        self.weight = nn.Parameter(init_weight(
            (features, in_features, kernel_size), "lecun_normal", generator,
            fan_in=in_features * kernel_size))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.weight.shape[-1] == 1:
            return F.linear(x, self.weight[..., 0], self.bias)
        out = F.conv1d(x.transpose(1, 2), self.weight, self.bias,
                       padding=self.dilation, dilation=self.dilation)
        return out.transpose(1, 2)


class ConvFeedForward(Conv1d):
    """Dilated width-3 conv, then ReLU."""

    def __init__(self, dim: int, dilation: int, *,
                 generator: torch.Generator):
        super().__init__(dim, dim, 3, dilation, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(super().forward(x))


class MambaAttModule(nn.Module):
    """Encoder layer: feed-forward → α·MaskMambaBlock(instance norm) +
    feed-forward → dropout → residual, masked."""

    def __init__(self, dim: int, dilation: int, alpha: float = 1.0,
                 drop_path_rate: float = 0.3, mixer: str = "vim", *,
                 generator: torch.Generator):
        super().__init__()
        self.alpha = alpha
        self.feed_forward = ConvFeedForward(dim, dilation,
                                            generator=generator)
        self.mamba_block = MaskMambaBlock(dim, mixer=mixer,
                                          drop_path_rate=drop_path_rate,
                                          device="cpu", generator=generator)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        out = self.feed_forward(x)
        h, _ = self.mamba_block(instance_norm_1d(out, mask), mask, generator)
        out = dropout(self.alpha * h + out, LAYER_DROPOUT, self.training,
                      generator)
        return (x + out) * mask.to(x.dtype)[..., None]


class AttnAttModule(nn.Module):
    """Decoder layer: feed-forward → sliding-window cross attention of the
    instance-normed stream (window ``dilation``; values from the encoder's
    features, or the stream itself without them) → α·attention +
    feed-forward → conv 1x1 → dropout → residual, masked."""

    def __init__(self, dim: int, dilation: int, alpha: float, r1: int = 2,
                 r2: int = 2, *, generator: torch.Generator):
        super().__init__()
        self.dilation = dilation
        self.alpha = alpha
        self.feed_forward = ConvFeedForward(dim, dilation,
                                            generator=generator)
        self.query_conv = Conv1d(dim, dim // r1, generator=generator)
        self.key_conv = Conv1d(dim, dim // r1, generator=generator)
        self.value_conv = Conv1d(dim, dim // r2, generator=generator)
        self.conv_out = Conv1d(dim // r2, dim, generator=generator)
        self.conv_1x1 = Conv1d(dim, dim, generator=generator)

    def forward(self, x: torch.Tensor, f_encoder: Optional[torch.Tensor],
                mask: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        out = self.feed_forward(x)
        h = instance_norm_1d(out, mask)
        v = self.value_conv(f_encoder if f_encoder is not None else h)
        att = sliding_window_attention(self.query_conv(h), self.key_conv(h),
                                       v, mask, self.dilation)
        att = self.conv_out(torch.relu(att)) * mask.to(out.dtype)[..., None]
        out = self.conv_1x1(self.alpha * att + out)
        out = dropout(out, LAYER_DROPOUT, self.training, generator)
        return (x + out) * mask.to(x.dtype)[..., None]


class TasEncoder(nn.Module):
    """Conv 1x1 → ``num_layers`` MambaAttModules (dilation 2^i) → conv 1x1
    to the classes; in training mode whole input channels are dropped at
    ``channel_masking_rate`` (one mask per sample and channel, the kept
    ones scaled). Returns (logits, features)."""

    def __init__(self, num_layers: int, num_f_maps: int, input_dim: int,
                 num_classes: int, channel_masking_rate: float = 0.3,
                 drop_path_rate: float = 0.3, mixer: str = "vim", *,
                 generator: torch.Generator):
        super().__init__()
        self.channel_masking_rate = channel_masking_rate
        self.conv_1x1 = Conv1d(input_dim, num_f_maps, generator=generator)
        self.layers = nn.ModuleList(
            MambaAttModule(num_f_maps, 2 ** i, 1.0, drop_path_rate, mixer,
                           generator=generator)
            for i in range(num_layers))
        self.conv_out = Conv1d(num_f_maps, num_classes, generator=generator)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        m = mask.to(x.dtype)[..., None]
        x = x * m
        rate = self.channel_masking_rate
        if self.training and rate > 0:
            if generator is None:
                raise ValueError("channel masking in training mode needs a "
                                 "torch.Generator")
            keep = torch.rand((x.shape[0], 1, x.shape[2]), device=x.device,
                              generator=generator) < 1.0 - rate
            x = torch.where(keep, x / (1.0 - rate), 0.0)
        feat = self.conv_1x1(x)
        for layer in self.layers:
            feat = layer(feat, mask, generator)
        return self.conv_out(feat) * m, feat


class TasDecoder(nn.Module):
    """Conv 1x1 from the classes → ``num_layers`` AttnAttModules (window
    2^i, α ``alpha``) → conv 1x1 to the classes. Returns (logits,
    features)."""

    def __init__(self, num_layers: int, num_f_maps: int, num_classes: int,
                 alpha: float, *, generator: torch.Generator):
        super().__init__()
        self.conv_1x1 = Conv1d(num_classes, num_f_maps, generator=generator)
        self.layers = nn.ModuleList(
            AttnAttModule(num_f_maps, 2 ** i, alpha, generator=generator)
            for i in range(num_layers))
        self.conv_out = Conv1d(num_f_maps, num_classes, generator=generator)

    def forward(self, x: torch.Tensor, f_encoder: torch.Tensor,
                mask: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        feat = self.conv_1x1(x)
        for layer in self.layers:
            feat = layer(feat, f_encoder, mask, generator)
        return self.conv_out(feat) * mask.to(feat.dtype)[..., None], feat


class MaTransformer(nn.Module):
    """The Mamba encoder and ``num_decoders`` attention decoders, each fed
    the masked softmax and the masked features of the stage before it. ``forward(x (B, L, input_dim), mask (B, L))`` returns
    the stages' logits (num_decoders + 1, B, L, num_classes). Random
    weights from ``seed``; built on ``device``, CUDA unless the caller
    passes "cpu"."""

    def __init__(self, num_decoders: int = 3, num_layers: int = 10,
                 num_f_maps: int = 64, input_dim: int = 2048,
                 num_classes: int = 11, channel_masking_rate: float = 0.3,
                 drop_path_rate: float = 0.3, mixer: str = "vim",
                 device="cuda", seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        g = torch.Generator().manual_seed(seed)
        self.num_classes = num_classes
        self.encoder = TasEncoder(num_layers, num_f_maps, input_dim,
                                  num_classes, channel_masking_rate,
                                  drop_path_rate, mixer, generator=g)
        self.decoders = nn.ModuleList(
            TasDecoder(num_layers, num_f_maps, num_classes,
                       exponential_descrease(s), generator=g)
            for s in range(num_decoders))
        self.to(device)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        out, feat = self.encoder(x, mask, generator)
        outputs = [out]
        m = mask.to(out.dtype)[..., None]
        for decoder in self.decoders:
            out, feat = decoder(torch.softmax(out, dim=-1) * m, feat * m,
                                mask, generator)
            outputs.append(out)
        return torch.stack(outputs, dim=0)
