"""RandAugment and RandomErasing for video clips, on the host in numpy (the
port's own copy of the JAX package's ``data/video_augment.py``, kept in
numpy so that the same ``np.random.Generator`` gives the same clips bit
for bit, in the same draw order).

The K400 fine-tuning recipe of the upstream action-recognition code
(``datasets/rand_augment.py`` and ``random_erasing.py``, used by
``kinetics_sparse.py`` with ``--aa rand-m7-n4-mstd0.5-inc1 --reprob 0.25
--remode pixel --recount 1``). Upstream maps timm's PIL ops over the
frames; here each op is vectorised over the whole (T, H, W, C) uint8 clip
with one parameter draw a clip, applied alike to every frame, which is
what upstream's ``AugmentOp`` does (one ``level_fn`` call, then the same
op on each frame). Geometric ops use an inverse-warp bilinear resampler
with timm's grey fill (128, 128, 128).
"""

from __future__ import annotations

import math
import re
from typing import Optional, Sequence, Tuple

import numpy as np

_MAX_LEVEL = 10.0
_FILL = 128.0


# ---------------------------------------------------------------------------
# pixel ops — clip: (T, H, W, C) uint8 → uint8


def _blend(degenerate: np.ndarray, img: np.ndarray, factor: float) -> np.ndarray:
    """ImageEnhance semantics: degenerate + factor·(img − degenerate)."""
    out = degenerate.astype(np.float32) + factor * (
        img.astype(np.float32) - degenerate.astype(np.float32))
    return np.clip(out, 0, 255).astype(np.uint8)


def _gray(clip: np.ndarray) -> np.ndarray:
    """PIL 'L' luma, kept as (T, H, W, 1)."""
    w = np.array([299, 587, 114], np.float32) / 1000.0
    g = (clip.astype(np.float32) @ w)
    return g[..., None]


def invert(clip, *_):
    return 255 - clip


def auto_contrast(clip, *_):
    out = np.empty_like(clip)
    for t in range(clip.shape[0]):
        for c in range(clip.shape[-1]):
            ch = clip[t, ..., c]
            lo, hi = int(ch.min()), int(ch.max())
            if hi <= lo:
                out[t, ..., c] = ch
            else:
                scale = 255.0 / (hi - lo)
                out[t, ..., c] = np.clip(
                    (ch.astype(np.float32) - lo) * scale, 0, 255
                ).astype(np.uint8)
    return out


def equalize(clip, *_):
    """PIL ImageOps.equalize: histogram equalization per channel."""
    out = np.empty_like(clip)
    for t in range(clip.shape[0]):
        for c in range(clip.shape[-1]):
            ch = clip[t, ..., c]
            hist = np.bincount(ch.ravel(), minlength=256)
            nonzero = hist[hist != 0]
            if len(nonzero) <= 1:
                out[t, ..., c] = ch
                continue
            step = (hist.sum() - nonzero[-1]) // 255
            if step == 0:
                out[t, ..., c] = ch
                continue
            lut = (np.cumsum(hist) - hist) // step  # PIL's n//step lut
            out[t, ..., c] = np.clip(lut, 0, 255).astype(np.uint8)[ch]
    return out


def posterize(clip, bits: int, *_):
    if bits >= 8:
        return clip
    if bits <= 0:
        return np.zeros_like(clip)
    mask = np.uint8(0xFF << (8 - bits) & 0xFF)
    return clip & mask


def solarize(clip, thresh: int, *_):
    return np.where(clip < thresh, clip, 255 - clip).astype(np.uint8)


def solarize_add(clip, add: int, thresh: int = 128, *_):
    lo = clip.astype(np.int16) + add
    return np.where(clip < thresh, np.clip(lo, 0, 255),
                    clip.astype(np.int16)).astype(np.uint8)


def color(clip, factor: float, *_):
    return _blend(np.broadcast_to(_gray(clip), clip.shape), clip, factor)


def contrast(clip, factor: float, *_):
    # PIL degenerate: solid grey at the mean of L (per frame)
    g = _gray(clip)[..., 0]
    mean = g.reshape(g.shape[0], -1).mean(axis=1) + 0.5
    deg = mean.astype(np.int32).astype(np.float32)[:, None, None, None]
    return _blend(np.broadcast_to(deg, clip.shape), clip, factor)


def brightness(clip, factor: float, *_):
    return _blend(np.zeros_like(clip), clip, factor)


def sharpness(clip, factor: float, *_):
    """PIL SMOOTH 3×3 kernel [[1,1,1],[1,5,1],[1,1,1]]/13, borders kept."""
    f = clip.astype(np.float32)
    sm = (f[:, :-2, :-2] + f[:, :-2, 1:-1] + f[:, :-2, 2:]
          + f[:, 1:-1, :-2] + 5 * f[:, 1:-1, 1:-1] + f[:, 1:-1, 2:]
          + f[:, 2:, :-2] + f[:, 2:, 1:-1] + f[:, 2:, 2:]) / 13.0
    deg = f.copy()
    deg[:, 1:-1, 1:-1] = sm
    return _blend(deg, clip, factor)


# ---------------------------------------------------------------------------
# geometric ops — shared inverse-warp bilinear resampler


def _affine(clip: np.ndarray, mat: Sequence[float],
            fill: float = _FILL) -> np.ndarray:
    """PIL Image.transform(AFFINE) semantics: output (x, y) samples input at
    (a·x + b·y + c, d·x + e·y + f); out-of-bounds → fill; bilinear."""
    a, b, c, d, e, f = mat
    T, H, W, C = clip.shape
    ys, xs = np.meshgrid(np.arange(H, dtype=np.float32),
                         np.arange(W, dtype=np.float32), indexing="ij")
    xi = a * xs + b * ys + c
    yi = d * xs + e * ys + f
    x0 = np.floor(xi).astype(np.int32)
    y0 = np.floor(yi).astype(np.int32)
    wx = (xi - x0)[..., None]
    wy = (yi - y0)[..., None]
    fclip = clip.astype(np.float32)

    def gather(yy, xx):
        valid = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
        yc = np.clip(yy, 0, H - 1)
        xc = np.clip(xx, 0, W - 1)
        v = fclip[:, yc, xc]                      # (T, H, W, C)
        return np.where(valid[None, ..., None], v, fill)

    v00 = gather(y0, x0)
    v01 = gather(y0, x0 + 1)
    v10 = gather(y0 + 1, x0)
    v11 = gather(y0 + 1, x0 + 1)
    out = ((1 - wy) * ((1 - wx) * v00 + wx * v01)
           + wy * ((1 - wx) * v10 + wx * v11))
    return np.clip(out, 0, 255).astype(np.uint8)


def rotate(clip, degrees: float, *_):
    """Rotate about the image centre (PIL Image.rotate, expand=False)."""
    T, H, W, C = clip.shape
    ang = math.radians(degrees)  # PIL rotates counter-clockwise
    cx, cy = (W - 1) / 2.0, (H - 1) / 2.0
    cos, sin = math.cos(ang), math.sin(ang)
    # inverse map: rotate output coords by -deg about centre
    mat = (cos, -sin, cx - cos * cx + sin * cy,
           sin, cos, cy - sin * cx - cos * cy)
    return _affine(clip, mat)


def shear_x(clip, factor: float, *_):
    return _affine(clip, (1, factor, 0, 0, 1, 0))


def shear_y(clip, factor: float, *_):
    return _affine(clip, (1, 0, 0, factor, 1, 0))


def translate_x_rel(clip, pct: float, *_):
    return _affine(clip, (1, 0, pct * clip.shape[2], 0, 1, 0))


def translate_y_rel(clip, pct: float, *_):
    return _affine(clip, (1, 0, 0, 0, 1, pct * clip.shape[1]))


# ---------------------------------------------------------------------------
# level functions (rand_augment.py:200-277, the *Increasing* variants)


def _enhance_inc(level, rng):
    v = (level / _MAX_LEVEL) * 0.9
    return (1.0 + (v if rng.random() < 0.5 else -v),)


_OPS = {
    # name: (fn, level_fn(level, rng) -> args tuple)
    "AutoContrast": (auto_contrast, None),
    "Equalize": (equalize, None),
    "Invert": (invert, None),
    "Rotate": (rotate, lambda l, r: (
        (l / _MAX_LEVEL) * 30.0 * (1 if r.random() < 0.5 else -1),)),
    "PosterizeIncreasing": (posterize, lambda l, r: (
        4 - int((l / _MAX_LEVEL) * 4),)),
    "SolarizeIncreasing": (solarize, lambda l, r: (
        256 - int((l / _MAX_LEVEL) * 256),)),
    "SolarizeAdd": (solarize_add, lambda l, r: (int((l / _MAX_LEVEL) * 110),)),
    "ColorIncreasing": (color, _enhance_inc),
    "ContrastIncreasing": (contrast, _enhance_inc),
    "BrightnessIncreasing": (brightness, _enhance_inc),
    "SharpnessIncreasing": (sharpness, _enhance_inc),
    "ShearX": (shear_x, lambda l, r: (
        (l / _MAX_LEVEL) * 0.3 * (1 if r.random() < 0.5 else -1),)),
    "ShearY": (shear_y, lambda l, r: (
        (l / _MAX_LEVEL) * 0.3 * (1 if r.random() < 0.5 else -1),)),
    "TranslateXRel": (translate_x_rel, lambda l, r: (
        (l / _MAX_LEVEL) * 0.45 * (1 if r.random() < 0.5 else -1),)),
    "TranslateYRel": (translate_y_rel, lambda l, r: (
        (l / _MAX_LEVEL) * 0.45 * (1 if r.random() < 0.5 else -1),)),
}


class RandAugmentVideo:
    """`rand-mM-nN-mstdS-inc1` policy over a uint8 (T, H, W, C) clip.

    Matches create_random_augment/rand_augment_transform semantics: N ops
    sampled per clip (with replacement), each applied with prob 0.5 at
    magnitude ~ N(M, S) clipped to [0, 10], identical across frames.
    """

    def __init__(self, config_str: str = "rand-m7-n4-mstd0.5-inc1",
                 seed: Optional[int] = None):
        self.magnitude, self.num_layers, self.mstd = 10, 2, 0.0
        assert config_str.startswith("rand"), config_str
        for part in config_str.split("-")[1:]:
            m = re.split(r"(\d.*)", part)
            if len(m) < 2:
                continue
            key, val = m[0], m[1]
            if key == "m":
                self.magnitude = int(val)
            elif key == "n":
                self.num_layers = int(val)
            elif key == "mstd":
                self.mstd = float(val)
            elif key == "inc":
                pass  # increasing transforms are the only set implemented
        self.ops = list(_OPS.keys())
        self.rng = np.random.default_rng(seed)

    def __call__(self, clip: np.ndarray,
                 rng: Optional[np.random.Generator] = None) -> np.ndarray:
        rng = rng or self.rng
        assert clip.dtype == np.uint8 and clip.ndim == 4
        names = rng.choice(self.ops, size=self.num_layers, replace=True)
        for name in names:
            if rng.random() > 0.5:
                continue
            fn, level_fn = _OPS[name]
            mag = self.magnitude
            if self.mstd > 0:
                mag = rng.normal(mag, self.mstd)
            mag = min(_MAX_LEVEL, max(0.0, mag))
            args = level_fn(mag, rng) if level_fn is not None else ()
            clip = fn(clip, *args)
        return clip


class RandomErasingVideo:
    """timm RandomErasing over the frame axis (random_erasing.py:60-120):
    each frame independently erased with prob `probability`; 'pixel' mode
    fills with standard-normal noise (applied on the NORMALIZED float clip,
    as in kinetics_sparse.py:224-233), 'const' with zeros.
    """

    def __init__(self, probability: float = 0.25, min_area: float = 0.02,
                 max_area: float = 1 / 3, min_aspect: float = 0.3,
                 mode: str = "pixel", max_count: int = 1,
                 seed: Optional[int] = None):
        self.probability = probability
        self.min_area, self.max_area = min_area, max_area
        self.log_aspect = (math.log(min_aspect), math.log(1 / min_aspect))
        self.mode = mode
        self.max_count = max_count
        self.rng = np.random.default_rng(seed)

    def _erase_frame(self, frame: np.ndarray, rng) -> None:
        H, W, C = frame.shape
        if rng.random() > self.probability:
            return
        count = (1 if self.max_count <= 1
                 else int(rng.integers(1, self.max_count + 1)))
        area = H * W
        for _ in range(count):
            for _ in range(10):
                target = rng.uniform(self.min_area, self.max_area) * area / count
                ar = math.exp(rng.uniform(*self.log_aspect))
                h = int(round(math.sqrt(target * ar)))
                w = int(round(math.sqrt(target / ar)))
                if 0 < h < H and 0 < w < W:
                    top = int(rng.integers(0, H - h + 1))
                    left = int(rng.integers(0, W - w + 1))
                    if self.mode == "pixel":
                        frame[top:top + h, left:left + w] = rng.standard_normal(
                            (h, w, C)).astype(frame.dtype)
                    elif self.mode == "rand":
                        frame[top:top + h, left:left + w] = rng.standard_normal(
                            (1, 1, C)).astype(frame.dtype)
                    else:
                        frame[top:top + h, left:left + w] = 0
                    break

    def __call__(self, clip: np.ndarray,
                 rng: Optional[np.random.Generator] = None) -> np.ndarray:
        rng = rng or self.rng
        assert clip.ndim == 4 and np.issubdtype(clip.dtype, np.floating)
        out = clip.copy()
        for t in range(out.shape[0]):
            self._erase_frame(out[t], rng)
        return out


def train_augment_clip(
    clip_uint8: np.ndarray,
    mean: Optional[Tuple[float, ...]] = (0.485, 0.456, 0.406),
    std: Optional[Tuple[float, ...]] = (0.229, 0.224, 0.225),
    rand_augment: Optional[RandAugmentVideo] = None,
    random_erasing: Optional[RandomErasingVideo] = None,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """The _aug_frame composition (kinetics_sparse.py:177-236): RandAugment
    on uint8 → normalize (mean=None ⇒ plain /255) → RandomErasing on the
    normalized clip. Crop / flip / resize stay in the device stage
    (data/video.py)."""
    rng = rng or np.random.default_rng()
    if rand_augment is not None:
        clip_uint8 = rand_augment(clip_uint8, rng)
    clip = clip_uint8.astype(np.float32) / 255.0
    if mean is not None:
        clip = (clip - np.asarray(mean, np.float32)) / np.asarray(
            std, np.float32)
    if random_erasing is not None:
        clip = random_erasing(clip, rng)
    return clip


def make_train_augment(aug_cfg: dict):
    """Preset-gated augment fn (run_class_finetuning.py:95-113 defaults:
    aa='rand-m7-n4-mstd0.5-inc1', reprob=0.25, remode='pixel', recount=1).
    Returns clip_uint8 → float32 fn, or None when the preset enables
    neither."""
    aa = aug_cfg.get("aa")
    reprob = float(aug_cfg.get("reprob", 0.0))
    if not aa and reprob <= 0:
        return None
    ra = RandAugmentVideo(aa) if aa else None
    re_ = (RandomErasingVideo(reprob, mode=aug_cfg.get("remode", "pixel"),
                              max_count=int(aug_cfg.get("recount", 1)))
           if reprob > 0 else None)
    mean = aug_cfg.get("mean")  # None ⇒ plain /255 (trainer convention)
    std = aug_cfg.get("std")

    def fn(clip_uint8, rng=None):
        return train_augment_clip(clip_uint8, mean=mean, std=std,
                                  rand_augment=ra, random_erasing=re_,
                                  rng=rng)

    return fn
