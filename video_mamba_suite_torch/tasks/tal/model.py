"""ActionMamba: a Mamba pyramid backbone, an FPN neck and point heads for
temporal action localization (counterpart of the JAX package's
``tasks/tal/model.py``): ``MambaBackbone``, ``FPNIdentity``, ``FPN1D``,
``PointGenerator``, ``ConvHead``, ``Scale`` and ``ActionMambaDetector``,
and the pure functions ``label_points``, ``tal_losses`` and
``decode_single_video``.

Activations are time-major, (B, T, C). On CUDA every mixer of the
pyramid scans through the kernels: a level of more than 64 steps runs K3
per direction (K4 in the backward), a shorter one K1 for both (K2 in the
backward). The convolutions are ``torch.nn.functional.conv1d``, as the
JAX package's are XLA convolutions.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...models.common import (
    LayerNorm1D,
    MaskedConv1D,
    MaskMambaBlock,
    resolve_device,
)
from .losses import ctr_diou_loss_1d, sigmoid_focal_loss

REGRESSION_RANGE = ((0, 4), (4, 8), (8, 16), (16, 32), (32, 64),
                    (64, 10000))


class MambaBackbone(nn.Module):
    """``arch[0]`` masked convs (each with a LayerNorm1D when ``with_ln``,
    then ReLU), ``arch[1]`` stem ``MaskMambaBlock`` s, then ``arch[2]``
    blocks that pool by ``scale_factor`` after their mixer: a pyramid of
    ``arch[2] + 1`` levels (the stem's output and each branch's)."""

    def __init__(self, n_in: int, n_embd: int = 512, n_embd_ks: int = 3,
                 arch: Tuple[int, int, int] = (2, 2, 5),
                 scale_factor: int = 2, with_ln: bool = False,
                 mixer: str = "dbm", drop_path_rate: float = 0.3, *,
                 generator: torch.Generator):
        super().__init__()
        self.embd = nn.ModuleList(
            MaskedConv1D(n_in if i == 0 else n_embd, n_embd, n_embd_ks,
                         use_bias=not with_ln, generator=generator)
            for i in range(arch[0]))
        self.embd_norm = nn.ModuleList(
            LayerNorm1D(n_embd) for _ in range(arch[0] if with_ln else 0))

        def block(stride):
            return MaskMambaBlock(n_embd, mixer=mixer, n_ds_stride=stride,
                                  drop_path_rate=drop_path_rate,
                                  device="cpu", generator=generator)

        self.stem = nn.ModuleList(block(1) for _ in range(arch[1]))
        self.branch = nn.ModuleList(block(scale_factor)
                                    for _ in range(arch[2]))

    def forward(self, x, mask, generator=None):
        x = x * mask.to(x.dtype)[..., None]
        for i, conv in enumerate(self.embd):
            x, mask = conv(x, mask)
            if len(self.embd_norm):
                x = self.embd_norm[i](x)
            x = F.relu(x)
        for blk in self.stem:
            x, mask = blk(x, mask, generator)
        feats, masks = [x], [mask]
        for blk in self.branch:
            x, mask = blk(x, mask, generator)
            feats.append(x)
            masks.append(mask)
        return feats, masks


class FPNIdentity(nn.Module):
    """A LayerNorm1D per level (when ``with_ln``), then the level's mask."""

    def __init__(self, levels: int, out_channel: int, with_ln: bool = True):
        super().__init__()
        self.norm = nn.ModuleList(
            LayerNorm1D(out_channel) for _ in range(levels if with_ln else 0))

    def forward(self, feats, masks):
        outs = []
        for i, (f, m) in enumerate(zip(feats, masks)):
            if len(self.norm):
                f = self.norm[i](f)
            outs.append(f * m.to(f.dtype)[..., None])
        return outs, masks


class FPN1D(nn.Module):
    """Top-down FPN: a 1-wide lateral conv per level, each level plus its
    coarser neighbour repeated twice, then a 3-wide conv and a LayerNorm1D
    (when ``with_ln``) per level."""

    def __init__(self, levels: int, in_channel: int, out_channel: int,
                 with_ln: bool = True, *, generator: torch.Generator):
        super().__init__()
        self.lateral = nn.ModuleList(
            MaskedConv1D(in_channel, out_channel, 1, use_bias=not with_ln,
                         generator=generator) for _ in range(levels))
        self.fpn_conv = nn.ModuleList(
            MaskedConv1D(out_channel, out_channel, 3, use_bias=not with_ln,
                         generator=generator) for _ in range(levels))
        self.fpn_norm = nn.ModuleList(
            LayerNorm1D(out_channel) for _ in range(levels if with_ln else 0))

    def forward(self, feats, masks):
        laterals = [conv(f, m)[0]
                    for conv, f, m in zip(self.lateral, feats, masks)]
        for i in range(len(laterals) - 1, 0, -1):
            up = torch.repeat_interleave(laterals[i], 2, dim=1)
            laterals[i - 1] = (laterals[i - 1]
                               + up[:, :laterals[i - 1].shape[1]])
        outs = []
        for i, (x, m) in enumerate(zip(laterals, masks)):
            x, _ = self.fpn_conv[i](x, m)
            if len(self.fpn_norm):
                x = self.fpn_norm[i](x)
            outs.append(x)
        return outs, masks


class PointGenerator:
    """Per-level point tables (T_l, 4): (t, regression range low, high,
    stride), t every stride = ``scale_factor``^l steps up to
    ``max_seq_len``. numpy on the host; the trainer keeps its device copy
    per level length."""

    def __init__(self, max_seq_len: int, fpn_levels: int, scale_factor: int,
                 regression_range: Sequence[Sequence[float]]):
        assert len(regression_range) == fpn_levels
        self.points = []
        for level in range(fpn_levels):
            stride = scale_factor ** level
            ts = np.arange(0, max_seq_len, stride, dtype=np.float32)
            rr = np.tile(np.asarray(regression_range[level], np.float32),
                         (len(ts), 1))
            ss = np.full((len(ts), 1), stride, np.float32)
            self.points.append(np.concatenate([ts[:, None], rr, ss], axis=1))

    def __call__(self, level_lengths: Sequence[int]) -> List[np.ndarray]:
        out = []
        for length, pts in zip(level_lengths, self.points):
            assert length <= pts.shape[0], "point buffer too small"
            out.append(pts[:length])
        return out


class ConvHead(nn.Module):
    """The heads' shared tower: ``num_layers - 1`` masked convs (each with
    a LayerNorm1D when ``with_ln``, then ReLU) and a final conv padded
    "SAME", masked. With ``prior_prob`` > 0 the final bias starts at
    -log((1 - p) / p), and at -log((1 - 1e-6) / 1e-6) for the classes of
    ``empty_cls``; else at 0. The final weight starts flax's default
    (lecun_normal)."""

    def __init__(self, in_dim: int, feat_dim: int, out_dim: int,
                 num_layers: int = 3, kernel_size: int = 3,
                 with_ln: bool = False, prior_prob: float = 0.0,
                 empty_cls: Sequence[int] = (), *,
                 generator: torch.Generator):
        super().__init__()
        self.head = nn.ModuleList(
            MaskedConv1D(in_dim if i == 0 else feat_dim, feat_dim,
                         kernel_size, use_bias=not with_ln,
                         generator=generator)
            for i in range(num_layers - 1))
        self.norm = nn.ModuleList(
            LayerNorm1D(feat_dim)
            for _ in range(num_layers - 1 if with_ln else 0))
        self.final = MaskedConv1D(feat_dim, out_dim, kernel_size,
                                  generator=generator, init="lecun_normal")
        with torch.no_grad():
            if prior_prob > 0:
                self.final.bias.fill_(-math.log((1 - prior_prob)
                                                / prior_prob))
                if len(empty_cls):
                    self.final.bias[list(empty_cls)] = -math.log(
                        (1 - 1e-6) / 1e-6)

    def forward(self, feats, masks):
        outs = []
        for f, m in zip(feats, masks):
            cur = f
            for i, conv in enumerate(self.head):
                cur, _ = conv(cur, m)
                if len(self.norm):
                    cur = self.norm[i](cur)
                cur = F.relu(cur)
            outs.append(self.final.conv(cur) * m.to(cur.dtype)[..., None])
        return outs


class Scale(nn.Module):
    """A learnable scalar ``scale``, initialised to 1."""

    def __init__(self):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(()))

    def forward(self, x):
        return x * self.scale


class ActionMambaDetector(nn.Module):
    """The single-stage detector (the JAX ``ActionMambaDetector``):
    ``forward(x (B, T, input_dim), mask (B, T))`` gives per-level lists of
    class logits (B, T_l, num_classes), ReLU'd offsets (B, T_l, 2) and
    masks (B, T_l). Label assignment, losses and decoding are the
    functions below.

    Builds on ``device`` (CUDA unless the caller passes "cpu"), random
    weights from ``seed`` (or ``generator``). In training mode the
    drop-path masks come from the ``generator`` given to ``forward``.
    """

    def __init__(self, input_dim: int, num_classes: int,
                 max_seq_len: int = 2304, embd_dim: int = 512,
                 fpn_dim: Optional[int] = None,
                 head_dim: Optional[int] = None,
                 backbone_arch: Tuple[int, int, int] = (2, 2, 5),
                 scale_factor: int = 2,
                 regression_range: Sequence[Sequence[float]] = (
                     REGRESSION_RANGE),
                 fpn_type: str = "identity", embd_with_ln: bool = True,
                 fpn_with_ln: bool = True, head_with_ln: bool = True,
                 head_kernel_size: int = 3, head_num_layers: int = 3,
                 cls_prior_prob: float = 0.01, drop_path_rate: float = 0.1,
                 mixer: str = "dbm", empty_cls: Sequence[int] = (), *,
                 device="cuda", seed: int = 0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        g = (generator if generator is not None
             else torch.Generator().manual_seed(seed))
        self.num_classes = num_classes
        self.max_seq_len = max_seq_len
        self.backbone_arch = tuple(backbone_arch)
        self.scale_factor = scale_factor
        self.regression_range = tuple(map(tuple, regression_range))
        self.drop_path_rate = drop_path_rate
        fpn_dim = fpn_dim or embd_dim
        head_dim = head_dim or embd_dim
        levels = self.fpn_levels
        self.backbone = MambaBackbone(
            input_dim, embd_dim, 3, self.backbone_arch, scale_factor,
            embd_with_ln, mixer, drop_path_rate, generator=g)
        if fpn_type == "identity":
            self.neck = FPNIdentity(levels, fpn_dim, fpn_with_ln)
        else:
            self.neck = FPN1D(levels, embd_dim, fpn_dim, fpn_with_ln,
                              generator=g)
        self.cls_head = ConvHead(fpn_dim, head_dim, num_classes,
                                 head_num_layers, head_kernel_size,
                                 head_with_ln, prior_prob=cls_prior_prob,
                                 empty_cls=empty_cls, generator=g)
        self.reg_head = ConvHead(fpn_dim, head_dim, 2, head_num_layers,
                                 head_kernel_size, head_with_ln,
                                 generator=g)
        self.scale = nn.ModuleList(Scale() for _ in range(levels))
        self.to(device)

    @property
    def fpn_levels(self) -> int:
        return self.backbone_arch[2] + 1

    def level_lengths(self, T: int) -> List[int]:
        """The pyramid's level lengths for an input of T steps."""
        lengths = [T]
        for _ in range(self.backbone_arch[2]):
            lengths.append(-(-lengths[-1] // self.scale_factor))
        return lengths

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        feats, masks = self.backbone(x, mask, generator)
        feats, masks = self.neck(feats, masks)
        cls_logits = self.cls_head(feats, masks)
        offsets = [F.relu(s(o)) for s, o in
                   zip(self.scale, self.reg_head(feats, masks))]
        return cls_logits, offsets, masks

    def make_points(self) -> PointGenerator:
        return PointGenerator(self.max_seq_len * 8, self.fpn_levels,
                              self.scale_factor, self.regression_range)


def label_points(points: torch.Tensor, gt_segments: torch.Tensor,
                 gt_labels: torch.Tensor, gt_valid: torch.Tensor,
                 num_classes: int, center_sample: str = "radius",
                 center_sample_radius: float = 1.5
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Centre-sampling assignment, vectorised over (batch, points, ground
    truths): each point takes the shortest valid segment that contains it
    (inside the radius around its centre, with "radius") and whose
    largest offset lies in the point's regression range; every segment
    within 1e-3 of that length adds its class.

    points (P, 4) over all levels; gt_segments (B, N, 2); gt_labels (B, N)
    int; gt_valid (B, N) bool. Returns cls_targets (B, P, C) in [0, 1] and
    reg_targets (B, P, 2), the offsets over the point's stride.
    """
    ts = points[:, 0]
    range_lo, range_hi, strides = points[:, 1], points[:, 2], points[:, 3]
    seg_lo = gt_segments[..., 0][:, None, :]                  # (B, 1, N)
    seg_hi = gt_segments[..., 1][:, None, :]
    lens = seg_hi - seg_lo
    left = ts[None, :, None] - seg_lo                         # (B, P, N)
    right = seg_hi - ts[None, :, None]
    reg_targets = torch.stack([left, right], dim=-1)          # (B, P, N, 2)
    if center_sample == "radius":
        centers = 0.5 * (seg_lo + seg_hi)
        t_mins = centers - strides[None, :, None] * center_sample_radius
        t_maxs = centers + strides[None, :, None] * center_sample_radius
        cb_left = ts[None, :, None] - torch.maximum(t_mins, seg_lo)
        cb_right = torch.minimum(t_maxs, seg_hi) - ts[None, :, None]
        inside = torch.minimum(cb_left, cb_right) > 0
    else:
        inside = reg_targets.amin(dim=-1) > 0
    max_reg = reg_targets.amax(dim=-1)
    in_range = ((max_reg >= range_lo[None, :, None])
                & (max_reg <= range_hi[None, :, None]))
    inf = torch.tensor(float("inf"), dtype=torch.float32,
                       device=points.device)
    lens_masked = torch.where(inside & in_range & gt_valid[:, None, :],
                              lens.expand_as(inside), inf)
    min_len = lens_masked.amin(dim=-1)                        # (B, P)
    # the first index of the minimum (jnp.argmin's tie rule)
    N = lens_masked.shape[-1]
    idx = torch.arange(N, device=points.device)
    min_idx = torch.where(lens_masked == min_len[..., None], idx,
                          N).amin(dim=-1)
    tie = (lens_masked <= min_len[..., None] + 1e-3) & (lens_masked < inf)
    # (B, N, C); by comparison, as F.one_hot reads the labels' range on
    # the host
    onehot = (gt_labels[..., None].long()
              == torch.arange(num_classes, device=points.device)).float()
    cls_targets = torch.clamp(
        torch.einsum("bpn,bnc->bpc", tie.float(), onehot), 0.0, 1.0)
    reg_sel = torch.gather(
        reg_targets, 2,
        min_idx[..., None, None].expand(-1, -1, 1, 2))[:, :, 0]
    return cls_targets, reg_sel / strides[None, :, None]


def tal_losses(fpn_masks: List[torch.Tensor],
               out_cls_logits: List[torch.Tensor],
               out_offsets: List[torch.Tensor], gt_cls: torch.Tensor,
               gt_offsets: torch.Tensor, loss_normalizer: torch.Tensor,
               num_classes: int, label_smoothing: float = 0.0,
               loss_weight: float = 1.0, normalizer_momentum: float = 0.9
               ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """The focal loss over every valid point and the DIoU loss over the
    positive ones, each over the moving average of the positive count:
    new = momentum · ``loss_normalizer`` + (1 − momentum) · max(count, 1).
    Returns ({"cls_loss", "reg_loss", "final_loss"}, new); the new
    normaliser carries no gradient."""
    valid_mask = torch.cat(fpn_masks, dim=1) > 0                 # (B, P)
    pos_mask = (gt_cls.sum(-1) > 0) & valid_mask
    num_pos = pos_mask.sum().float()
    new_norm = (normalizer_momentum * loss_normalizer
                + (1 - normalizer_momentum) * torch.clamp(num_pos, min=1))
    gt_target = (gt_cls * (1 - label_smoothing)
                 + label_smoothing / (num_classes + 1))
    logits = torch.cat(out_cls_logits, dim=1)                     # (B, P, C)
    cls_loss = (sigmoid_focal_loss(logits, gt_target)
                * valid_mask[..., None]).sum() / new_norm
    offsets = torch.cat(out_offsets, dim=1)                       # (B, P, 2)
    reg_el = ctr_diou_loss_1d(offsets.reshape(-1, 2),
                              gt_offsets.reshape(-1, 2)).reshape(
                                  pos_mask.shape)
    reg_loss = (reg_el * pos_mask).sum() / new_norm
    final = cls_loss + reg_loss * loss_weight
    return ({"cls_loss": cls_loss, "reg_loss": reg_loss,
             "final_loss": final}, new_norm.detach())


def decode_single_video(points: List[torch.Tensor],
                        fpn_masks: List[torch.Tensor],
                        cls_logits: List[torch.Tensor],
                        offsets: List[torch.Tensor],
                        pre_nms_thresh: float = 0.001,
                        pre_nms_topk: int = 2000,
                        duration_thresh: float = 0.05):
    """Per level: the sigmoid of the masked logits, its ``pre_nms_topk``
    largest (point, class) pairs on the device, their segments t −
    left · stride, t + right · stride; then one copy to the host, which
    keeps the pairs above ``pre_nms_thresh`` longer than
    ``duration_thresh``. Inputs are one video's (batch indexed): points
    (T_l, 4), masks (T_l,), logits (T_l, C), offsets (T_l, 2). Returns
    numpy (segments (K, 2), scores (K,), class indices (K,))."""
    rows = []
    for pts, m, logit, off in zip(points, fpn_masks, cls_logits, offsets):
        C = logit.shape[-1]
        prob = (torch.sigmoid(logit) * m[..., None].to(logit.dtype)
                ).reshape(-1)
        k = min(pre_nms_topk, prob.shape[0])
        topv, topi = torch.topk(prob, k)
        pt_idx = torch.div(topi, C, rounding_mode="floor")
        off_sel, pts_sel = off[pt_idx], pts[pt_idx]
        seg_l = pts_sel[:, 0] - off_sel[:, 0] * pts_sel[:, 3]
        seg_r = pts_sel[:, 0] + off_sel[:, 1] * pts_sel[:, 3]
        keep = (topv > pre_nms_thresh) & ((seg_r - seg_l) > duration_thresh)
        rows.append(torch.stack([seg_l, seg_r, topv.float(),
                                 (topi % C).float(), keep.float()], dim=1))
    out = torch.cat(rows).cpu().numpy()
    keep = out[:, 4] > 0
    return (out[keep, :2], out[keep, 2],
            out[keep, 3].astype(np.int32))
