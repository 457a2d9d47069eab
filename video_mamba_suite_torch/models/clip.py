"""CLIP dual encoder: a video tower (TimeMamba or ViViM) and a text
transformer (counterpart of the JAX package's ``models/clip.py``:
``ResidualAttentionBlock``, ``TextTransformer``, ``ClipImageTower``,
``CLIP`` and its builders).

The text tower and the image tower have no dtype in the JAX package, so
they run in fp32; the video tower takes its compute dtype from its config
(``dtype``). LayerNorms here use eps 1e-5 (the upstream towers' torch
default). Every module is built on ``device`` ("cuda" unless the caller
asks for "cpu") from ``torch.Generator``s seeded with ``seed``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from .common import Embedding, FusedMHA, LayerNorm, PatchifyConv, \
    resolve_device
from .timemamba import Mlp, TimeMamba
from .vivim import ViViM

LN_EPS = 1e-5


class ResidualAttentionBlock(nn.Module):
    """Pre-LN transformer block: x + attn(ln_1(x)), then x + mlp(ln_2(x)),
    with the exact-erf GELU in fp32; the attention takes the einsum path
    (``FusedMHA`` without ``flash``), as in the JAX package."""

    def __init__(self, width: int, heads: int, causal: bool = True, *,
                 generator: torch.Generator):
        super().__init__()
        self.ln_1 = LayerNorm(width, eps=LN_EPS)
        self.attn = FusedMHA(width, heads, causal=causal, generator=generator)
        self.ln_2 = LayerNorm(width, eps=LN_EPS)
        self.mlp = Mlp(width, 4 * width, dtype=None, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


def _normal(shape, std: float, generator: torch.Generator) -> nn.Parameter:
    return nn.Parameter(std * torch.randn(*shape, generator=generator))


class TextTransformer(nn.Module):
    """CLIP text tower: token and position embedding, causal pre-LN blocks,
    ``ln_final``, pooling at the argmax token id (the eot token; the first
    one where several tie) and ``text_projection`` (width, output_dim)."""

    def __init__(self, context_length: int = 77, vocab_size: int = 49408,
                 width: int = 512, heads: int = 8, layers: int = 12,
                 output_dim: Optional[int] = 512, causal_mask: bool = True,
                 *, generator: torch.Generator):
        super().__init__()
        self.token_embedding = Embedding(vocab_size, width,
                                         generator=generator)
        self.positional_embedding = _normal((context_length, width), 0.01,
                                            generator)
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, causal=causal_mask,
                                   generator=generator)
            for _ in range(layers))
        self.ln_final = LayerNorm(width, eps=LN_EPS)
        self.text_projection = (None if output_dim is None else _normal(
            (width, output_dim), width ** -0.5, generator))

    def forward(self, text: torch.Tensor,
                return_tokens: bool = False) -> torch.Tensor:
        """text (B, L) token ids → (B, output_dim); with ``return_tokens``
        the per-token ``ln_final`` states (B, L, width)."""
        x = self.token_embedding(text)
        x = x + self.positional_embedding[:x.shape[1]].to(x.dtype)
        for blk in self.resblocks:
            x = blk(x)
        x = self.ln_final(x)
        if return_tokens:
            return x
        eot = text.argmax(dim=-1)
        x = x[torch.arange(x.shape[0], device=x.device), eot]
        if self.text_projection is not None:
            x = x @ self.text_projection.to(x.dtype)
        return x


class ClipImageTower(nn.Module):
    """Standard CLIP ViT image encoder, per frame: patch embedding without
    bias, class token, positions, ``ln_pre``, non-causal blocks,
    ``ln_post`` on the class token and ``proj`` (width, output_dim)."""

    def __init__(self, img_size: int = 224, patch_size: int = 32,
                 width: int = 768, layers: int = 12, heads: int = 12,
                 output_dim: Optional[int] = 512, *,
                 generator: torch.Generator):
        super().__init__()
        self.width = width
        self.conv1 = PatchifyConv(3, width, patch_size, bias=False,
                                  generator=generator)
        scale = width ** -0.5
        tokens = (img_size // patch_size) ** 2 + 1
        self.class_embedding = _normal((width,), scale, generator)
        self.positional_embedding = _normal((tokens, width), scale, generator)
        self.ln_pre = LayerNorm(width, eps=LN_EPS)
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, causal=False,
                                   generator=generator)
            for _ in range(layers))
        self.ln_post = LayerNorm(width, eps=LN_EPS)
        self.proj = (None if output_dim is None
                     else _normal((width, output_dim), scale, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, 3) → (B, output_dim)."""
        B = x.shape[0]
        feat = self.conv1(x).reshape(B, -1, self.width)
        cls = self.class_embedding.to(feat.dtype).expand(B, 1, self.width)
        feat = torch.cat([cls, feat], dim=1)
        feat = self.ln_pre(feat + self.positional_embedding.to(feat.dtype))
        for blk in self.resblocks:
            feat = blk(feat)
        feat = self.ln_post(feat[:, 0])
        if self.proj is not None:
            feat = feat @ self.proj.to(feat.dtype)
        return feat


VISION_TOWERS = {"timemamba": TimeMamba, "vivim": ViViM}


class CLIP(nn.Module):
    """Dual encoder with a learnable temperature. ``vision_cfg`` holds the
    video tower's constructor arguments (its ``dtype`` among them), and
    ``text_cfg`` the text tower's; both towers project to ``embed_dim``.
    The forward returns the L2-normalised video and text embeddings (fp32)
    and exp(logit_scale); ``freeze_temperature`` stops the scale's
    gradient. In training mode the video tower's dropout and drop-path
    draw their masks from the ``torch.Generator`` passed to ``forward``
    (the JAX ``deterministic=False`` with a "dropout" rng); the text tower
    has none."""

    def __init__(self, embed_dim: int = 512, vision_tower: str = "timemamba",
                 vision_cfg: Optional[dict] = None,
                 text_cfg: Optional[dict] = None,
                 freeze_temperature: bool = False, device="cuda",
                 seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        if vision_tower not in VISION_TOWERS:
            raise ValueError(f"unknown vision tower {vision_tower!r}")
        vc = dict(vision_cfg or {})
        vc.setdefault("output_dim", embed_dim)
        self.visual = VISION_TOWERS[vision_tower](**vc, device="cpu",
                                                  seed=seed)
        tc = dict(text_cfg or {})
        tc.setdefault("output_dim", embed_dim)
        self.textual = TextTransformer(
            **tc, generator=torch.Generator().manual_seed(seed + 1))
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))
        self.freeze_temperature = freeze_temperature
        self.to(device)

    def encode_image(self, image: torch.Tensor,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
        return self.visual(image, generator)

    def encode_text(self, text: torch.Tensor) -> torch.Tensor:
        return self.textual(text)

    def forward(self, image: torch.Tensor, text: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        img = self.encode_image(image, generator).float()
        txt = self.encode_text(text).float()
        img = img / img.norm(dim=-1, keepdim=True).clamp_min(1e-8)
        txt = txt / txt.norm(dim=-1, keepdim=True).clamp_min(1e-8)
        scale = self.logit_scale.exp()
        if self.freeze_temperature:
            scale = scale.detach()
        return img, txt, scale


_TEXT_B = dict(width=512, heads=8, layers=12)


def clip_timemamba_base(num_frames: int = 4, project_embed_dim: int = 512,
                        device="cuda", seed: int = 0, **kw) -> CLIP:
    """CLIP_TimeMamba_like_timesformer: ViT-B/16 spatial tower with Mamba
    time adapters ("timesformer-div", tanh gates) and CLIP's text-B.
    ``kw`` changes any video-tower argument (``dtype``, ``attn_flash``,
    ``depth``, ...)."""
    cfg = dict(embed_dim=768, depth=12, num_heads=12, num_frames=num_frames,
               ln_pre=True, attention_style="timesformer-div",
               is_tanh_gating=True)
    cfg.update(kw)
    return CLIP(embed_dim=project_embed_dim, vision_tower="timemamba",
                vision_cfg=cfg, text_cfg=dict(_TEXT_B), device=device,
                seed=seed)


def clip_timemamba_frozen(num_frames: int = 4, project_embed_dim: int = 512,
                          device="cuda", seed: int = 0, **kw) -> CLIP:
    """CLIP_TimeMamba_like_frozen: the frozen-in-time residual style."""
    return clip_timemamba_base(num_frames, project_embed_dim, device, seed,
                               **dict(kw, attention_style="frozen-in-time"))


def clip_timemamba_frozen_joint(num_frames: int = 4,
                                project_embed_dim: int = 512, device="cuda",
                                seed: int = 0, **kw) -> CLIP:
    """CLIP_TimeMamba_like_frozen_joint: the temporal Mamba scans the joint
    (n·t) token sequence."""
    return clip_timemamba_base(num_frames, project_embed_dim, device, seed,
                               **dict(kw, attention_style="frozen-joint"))


def _clip_vivim(embed_dim: int, num_frames: int, project_embed_dim: int,
                device, seed: int, **vision) -> CLIP:
    return CLIP(embed_dim=project_embed_dim, vision_tower="vivim",
                vision_cfg=dict(embed_dim=embed_dim, depth=24,
                                num_frames=num_frames, if_devide_out=True,
                                **vision),
                text_cfg=dict(_TEXT_B), device=device, seed=seed)


def clip_vivim_tiny(num_frames: int = 16, project_embed_dim: int = 512,
                    device="cuda", seed: int = 0) -> CLIP:
    """CLIP_ViViM_tiny: ViViM-T (width 192, depth 24) and text-B."""
    return _clip_vivim(192, num_frames, project_embed_dim, device, seed)


def clip_vivim_tiny_hs4(num_frames: int = 16, project_embed_dim: int = 512,
                        device="cuda", seed: int = 0) -> CLIP:
    """CLIP_ViViM_tiny_hs4: ViViM-T with d_state 4."""
    return _clip_vivim(192, num_frames, project_embed_dim, device, seed,
                       d_state=4)


def clip_vivim_small(num_frames: int = 16, project_embed_dim: int = 512,
                     device="cuda", seed: int = 0) -> CLIP:
    """CLIP_ViViM_small: ViViM-S (width 384, depth 24) and text-B."""
    return _clip_vivim(384, num_frames, project_embed_dim, device, seed)
