"""Grounding on a raw video and a free-text query (the port's counterpart of
the JAX package's ``tasks/vtg/run_on_video.py``; upstream UniVTG's
``run_on_video/``): frames at one per ``clip_len`` seconds through a CLIP
image tower, the query's per-token text features (upstream
``ClipFeatureExtractor.encode_text`` keeps ``last_hidden_state``), then the
VTG model ranks spans and scores each clip's saliency.

``VtgFeatureExtractor`` holds a ``ClipImageTower`` and a
``TextTransformer`` (weights from a JAX tree through
``models.convert.clip_image_tower_from_jax`` / ``text_transformer_from_jax``,
or random from a seed); ``ground_video`` decodes spans as
``VtgTrainer.predict`` does.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from ...data.video import CLIP_MEAN, CLIP_STD, VideoDecoder, \
    resize_crop_normalize
from ...models.clip import ClipImageTower, TextTransformer
from ...models.common import resolve_device
from .data import build_targets, collate_vtg


class VtgFeatureExtractor:
    """CLIP frame features and per-token query features at one frame per
    ``clip_len`` seconds. ``image_state`` / ``text_state`` are the towers'
    state dicts (random weights from ``seed`` where None);
    ``image_cfg`` / ``text_cfg`` their constructor arguments. The towers
    run in fp32 on ``device`` (the card unless the caller asks for "cpu").
    The tokenizer defaults to an empty ``WordTokenizer`` (every word
    unknown) at the text tower's context length."""

    def __init__(self, image_state: Optional[Dict[str, torch.Tensor]] = None,
                 text_state: Optional[Dict[str, torch.Tensor]] = None,
                 image_cfg: Optional[Dict[str, Any]] = None,
                 text_cfg: Optional[Dict[str, Any]] = None,
                 tokenizer=None, clip_len: float = 2.0, device="cuda",
                 seed: int = 0):
        self.device = resolve_device(device)
        self.image_cfg = dict(image_cfg or {})
        text_cfg = dict(text_cfg or {})
        self.image_tower = ClipImageTower(
            **self.image_cfg, generator=torch.Generator().manual_seed(seed))
        self.text_tower = TextTransformer(
            **text_cfg, generator=torch.Generator().manual_seed(seed + 1))
        for tower, state in ((self.image_tower, image_state),
                             (self.text_tower, text_state)):
            if state is not None:
                tower.load_state_dict(state, strict=True)
            tower.to(self.device).eval()
        self.clip_len = clip_len
        if tokenizer is None:
            from ...data.tokenizer import WordTokenizer

            tokenizer = WordTokenizer(
                context_length=text_cfg.get("context_length", 77))
        self.tokenizer = tokenizer

    def video_features(self, video_path: str,
                       size: Optional[int] = None) -> np.ndarray:
        """Decode one frame every ``clip_len`` seconds, resize the short
        side to the tower's image size (bilinear, antialiased where it
        shrinks), centre-crop, CLIP-normalise, encode: L2-normalised
        (T, D) fp32."""
        size = size or self.image_cfg.get("img_size", 224)
        dec = VideoDecoder(video_path)
        step = max(1, int(round(dec.fps * self.clip_len)))
        frames = torch.from_numpy(dec.get_batch(
            list(range(0, dec.num_frames, step)))).to(self.device)
        _, h, w, _ = frames.shape
        scale = size / min(h, w)
        nh, nw = int(round(h * scale)), int(round(w * scale))
        x = resize_crop_normalize(frames, nh, nw, size, (nh - size) // 2,
                                  (nw - size) // 2, False, CLIP_MEAN,
                                  CLIP_STD)
        with torch.inference_mode():
            feats = self.image_tower(x).float()
            feats = feats / feats.norm(dim=-1, keepdim=True).clamp_min(1e-8)
        return feats.cpu().numpy()

    def text_features(self, queries: Sequence[str]) -> list:
        """Each query's per-token features (the text tower's ``ln_final``
        states) cut to its non-padding tokens and L2-normalised per token:
        a list of (L_j, width) fp32."""
        toks = np.asarray(self.tokenizer(list(queries)))
        with torch.inference_mode():
            feats = self.text_tower(
                torch.from_numpy(toks.astype(np.int64)).to(self.device),
                return_tokens=True).float().cpu().numpy()
        out = []
        for j in range(len(queries)):
            valid = int((toks[j] != 0).sum())
            f = feats[j, :max(valid, 1)]
            out.append(f / np.maximum(
                np.linalg.norm(f, axis=-1, keepdims=True), 1e-8))
        return out


def ground_video(extractor: VtgFeatureExtractor, vtg_model, video_path: str,
                 query: str, top_k: int = 5, use_tef: bool = True,
                 max_q_l: int = 32, max_v_l: int = 75) -> Dict[str, Any]:
    """A raw video and a query → the ``top_k`` spans [start_s, end_s,
    score] by foreground probability and each clip's saliency (upstream's
    ``run.py`` result). The video features get the temporal endpoint
    features (start, end over T) where ``use_tef``; the model (a
    ``UniVTGMamba`` holding its weights) runs in eval mode on its own
    device."""
    vfeat = extractor.video_features(video_path)
    T = len(vfeat)
    clip_len = extractor.clip_len
    duration = T * clip_len
    if use_tef:
        st = np.arange(T, dtype=np.float32) / T
        tef = np.stack([st, st + 1.0 / T], axis=1)
        vfeat = np.concatenate([vfeat, tef], axis=1)
    qfeat = extractor.text_features([query])[0]
    sample = dict(
        qid=0, txt_feat=qfeat, vid_feat=vfeat,
        targets=build_targets(T, [[0.0, duration]], clip_len),
        relevant_windows=[[0.0, duration]], duration=duration,
        clip_len=clip_len,
    )
    batch = collate_vtg([sample], max_q_l, max_v_l)
    device = next(vtg_model.parameters()).device
    vtg_model.eval()
    with torch.inference_mode():
        out = vtg_model(*(torch.from_numpy(batch[k]).to(device) for k in
                          ("src_txt", "src_txt_mask", "src_vid",
                           "src_vid_mask")))
        host = torch.cat([out["pred_spans"], out["pred_logits"],
                          out["saliency_scores"][..., None]],
                         dim=-1).float().cpu().numpy()[0]
    spans = batch["timestamp"][0] + host[:, :2]
    prob = host[:, 2]
    lv = min(T, max_v_l)
    sp = np.clip(spans[:lv] * duration, 0, duration)
    order = np.argsort(-prob[:lv])[:top_k]
    windows = [[float(sp[k, 0]), float(sp[k, 1]), float(prob[k])]
               for k in order]
    saliency = host[:lv, 3].astype(np.float32)
    return {"query": query, "pred_relevant_windows": windows,
            "pred_saliency_scores": saliency.tolist()}
