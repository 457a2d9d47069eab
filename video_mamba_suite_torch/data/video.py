"""Raw-video decode and preprocessing (the port's own copy of the JAX
package's ``data/video.py``).

The host decodes frames (``VideoDecoder``: ``.npy`` frame arrays, then
decord, PyAV or OpenCV, whichever imports first); resize, crop, flip and
normalisation run on the device as one torch stage (``preprocess_clip``),
the counterpart of the JAX package's jitted stage. The resize is bilinear
with antialiasing when it shrinks, as ``jax.image.resize`` is.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def _detect_backend() -> Optional[str]:
    for name in ("decord", "av", "cv2"):
        try:
            __import__(name)
            return name
        except ImportError:
            continue
    import shutil

    if shutil.which("ffmpeg"):
        return "ffmpeg"
    return None


class VideoDecoder:
    """A video reader, ``get_batch(indices)`` → uint8 (N, H, W, 3) frames.

    A ``.npy`` path is a memory-mapped (T, H, W, 3) uint8 frame array read
    at 30 fps; other files go to the first backend that imports (decord,
    av, cv2), or to ffmpeg, which raises ``NotImplementedError``. Without
    any backend the constructor raises. decord gets ``width`` / ``height``
    (its fused resize) when ``width`` > 0. OpenCV repeats the last frame
    where a frame does not read (224² zeros before the first).
    """

    def __init__(self, path: str, backend: Optional[str] = None,
                 width: int = -1, height: int = -1):
        self.path = path
        if backend is None and path.endswith(".npy"):
            backend = "npy"
        self.backend = backend or _detect_backend()
        self.width, self.height = width, height
        if self.backend is None:
            raise RuntimeError(
                "no video decode backend available (decord/av/cv2/ffmpeg); "
                "install one or use precomputed features"
            )
        self._open()

    def _open(self):
        if self.backend == "npy":
            self._frames = np.load(self.path, mmap_mode="r")
            self.num_frames = self._frames.shape[0]
            self.fps = 30.0
        elif self.backend == "decord":
            import decord

            kw = {}
            if self.width > 0:
                kw = dict(width=self.width, height=self.height)
            self._vr = decord.VideoReader(self.path, num_threads=1, **kw)
            self.num_frames = len(self._vr)
            self.fps = float(self._vr.get_avg_fps())
        elif self.backend == "av":
            import av

            self._container = av.open(self.path)
            stream = self._container.streams.video[0]
            self.num_frames = stream.frames
            self.fps = float(stream.average_rate)
        elif self.backend == "cv2":
            import cv2

            self._cap = cv2.VideoCapture(self.path)
            if not self._cap.isOpened():
                raise RuntimeError(f"cv2 could not open {self.path!r}")
            self.num_frames = int(self._cap.get(cv2.CAP_PROP_FRAME_COUNT))
            self.fps = float(self._cap.get(cv2.CAP_PROP_FPS))
        elif self.backend == "ffmpeg":
            raise NotImplementedError(
                "ffmpeg-pipe backend requires the ffmpeg binary at runtime"
            )

    def get_batch(self, indices: Sequence[int]) -> np.ndarray:
        """(N, H, W, 3) uint8 frames at the given indices."""
        if self.backend == "npy":
            return np.asarray(self._frames[np.asarray(indices, int)])
        if self.backend == "decord":
            return self._vr.get_batch(list(indices)).asnumpy()
        if self.backend == "av":
            wanted = set(int(i) for i in indices)
            frames = {}
            self._container.seek(0)
            for i, frame in enumerate(self._container.decode(video=0)):
                if i in wanted:
                    frames[i] = frame.to_ndarray(format="rgb24")
                if len(frames) == len(wanted):
                    break
            return np.stack([frames[int(i)] for i in indices])
        if self.backend == "cv2":
            import cv2

            out = []
            for i in indices:
                self._cap.set(cv2.CAP_PROP_POS_FRAMES, int(i))
                ok, frame = self._cap.read()
                if not ok:
                    frame = out[-1] if out else np.zeros((224, 224, 3),
                                                         np.uint8)
                out.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
            return np.stack(out)
        raise RuntimeError(self.backend)


def sample_frame_indices(num_frames: int, total: int, mode: str = "sparse",
                         clip_idx: int = 0, num_clips: int = 1,
                         rng: Optional[np.random.Generator] = None
                         ) -> np.ndarray:
    """Frame indices of a clip.

    "sparse": segment-uniform sampling, one frame in each of
    ``num_frames`` equal segments: drawn from ``rng`` where it is given
    (training), else at the same fraction (clip_idx + 0.5) / num_clips of
    every segment (the ``clip_idx``-th view of a multi-view test).
    "uniform": evenly spaced over the video.
    """
    total = max(total, 1)
    if mode == "uniform":
        return np.linspace(0, total - 1, num_frames).round().astype(np.int64)
    seg = np.linspace(0, total, num_frames + 1)
    idx = []
    for i in range(num_frames):
        lo, hi = int(seg[i]), max(int(seg[i + 1]) - 1, int(seg[i]))
        if rng is not None:
            idx.append(int(rng.integers(lo, hi + 1)))
        else:
            frac = (clip_idx + 0.5) / max(num_clips, 1)
            idx.append(int(round(lo + (hi - lo) * frac)))
    return np.asarray(idx, np.int64)


def resize_crop_normalize(frames: torch.Tensor, new_h: int, new_w: int,
                          size: int, top: int, left: int, flip: bool,
                          mean: Tuple[float, ...], std: Tuple[float, ...]
                          ) -> torch.Tensor:
    """uint8 (T, H, W, 3) on the device → float32 (T, size, size, 3):
    /255, bilinear resize to (new_h, new_w) (antialiased where it
    shrinks), the size² crop at (top, left), a horizontal flip where
    ``flip``, then (x - mean) / std."""
    x = frames.to(torch.float32).div(255.0).permute(0, 3, 1, 2)
    x = F.interpolate(x, size=(new_h, new_w), mode="bilinear",
                      align_corners=False, antialias=True)
    x = x[:, :, top:top + size, left:left + size]
    if flip:
        x = x.flip(-1)
    x = x.permute(0, 2, 3, 1)
    m = torch.tensor(mean, dtype=torch.float32, device=x.device)
    s = torch.tensor(std, dtype=torch.float32, device=x.device)
    return ((x - m) / s).contiguous()


def _scaled_shape(h: int, w: int, size: int, train: bool) -> Tuple[int, int]:
    """The resize target: the short side at size · 1.15 in training, at
    size · 256 // 224 otherwise."""
    scale = size * 1.15 if train else size * 256 // 224
    return (int(round(h * float(scale) / min(h, w))),
            int(round(w * float(scale) / min(h, w))))


def _preprocess_clip_at(frames, size: int, train: bool, top: int, left: int,
                        flip: bool, mean, std, device) -> torch.Tensor:
    """``preprocess_clip`` with the crop offsets and the flip given (the
    centre and no flip outside training)."""
    x = torch.as_tensor(frames).to(device)
    T, H, W, _ = x.shape
    new_h, new_w = _scaled_shape(H, W, size, train)
    if not train:
        top, left, flip = (new_h - size) // 2, (new_w - size) // 2, False
    return resize_crop_normalize(x, new_h, new_w, size, top, left, flip,
                                 mean, std)


def preprocess_clip(frames, generator: Optional[torch.Generator] = None,
                    size: int = 224, train: bool = False,
                    mean: Tuple[float, ...] = CLIP_MEAN,
                    std: Tuple[float, ...] = CLIP_STD,
                    device="cuda") -> torch.Tensor:
    """The device stage: uint8 (T, H, W, 3) → float32 (T, size, size, 3)
    on ``device`` (the card unless the caller asks for "cpu"): /255, the
    bilinear resize of the short side to size · 1.15 (training) or size ·
    256 // 224, a random crop and horizontal flip (training: ``top``,
    ``left`` and the flip drawn from ``generator``, a CPU generator seeded
    0 when none is given) or the centre crop, then normalisation."""
    from ..models.common import resolve_device

    device = resolve_device(device)
    top = left = 0
    flip = False
    if train:
        g = generator if generator is not None else \
            torch.Generator().manual_seed(0)
        T, H, W, _ = frames.shape
        new_h, new_w = _scaled_shape(H, W, size, train)
        gd = g.device
        top = int(torch.randint(0, new_h - size + 1, (), generator=g,
                                device=gd))
        left = int(torch.randint(0, new_w - size + 1, (), generator=g,
                                 device=gd))
        flip = bool(torch.rand((), generator=g, device=gd) < 0.5)
    return _preprocess_clip_at(frames, size, train, top, left, flip,
                               tuple(mean), tuple(std), device)


def synthetic_video(num_frames: int = 16, size: int = 224, seed: int = 0
                    ) -> np.ndarray:
    """Deterministic uint8 test video (moving gradient)."""
    rng = np.random.default_rng(seed)
    t = np.arange(num_frames)[:, None, None, None]
    y = np.arange(size)[None, :, None, None]
    x = np.arange(size)[None, None, :, None]
    base = (x + y + 8 * t) % 256
    noise = rng.integers(0, 16, (num_frames, size, size, 3))
    return np.clip(base + noise, 0, 255).astype(np.uint8)
