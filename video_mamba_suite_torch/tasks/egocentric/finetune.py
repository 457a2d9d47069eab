"""EK100 multi-instance retrieval (MIR) with the CLIP dual encoder: the
serving half of the JAX package's ``MirFinetuner``
(``tasks/egocentric/finetune.py``): encode the evaluation set's clips and
captions, score (sim + 1) / 2 and compute mAP and nDCG against the
relevancy matrix, as upstream's ``validate_mir`` does. The fine-tuning
step (max-margin ranking loss, AdamW) is not ported yet.

``build_clip_mir`` is the entry point: CLIP-TimeMamba-B at the EK100 MIR
preset's widths, random weights from a seed, on the card.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ...configs import CLIP_TIMEMAMBA_B_EK100_MIR
from ...models.clip import CLIP
from .metrics import get_mAP, get_nDCG


class MirFinetuner:
    """EK100 MIR engine around a ``CLIP``: ``encode_dataset`` embeds the
    evaluation set in batches, ``evaluate`` scores it."""

    def __init__(self, model: CLIP):
        self.model = model

    def encode_dataset(self, videos, texts, batch_size: int = 8
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """Normalised embeddings (n, embed_dim) of the clips (n, T, H, W, 3)
        and of the token ids (n, L), as numpy fp32, encoded in batches of
        ``batch_size`` (clip i with caption i) under inference mode."""
        device = next(self.model.parameters()).device
        was_training = self.model.training
        self.model.eval()
        vids, txts = [], []
        with torch.inference_mode():
            for i in range(0, len(videos), batch_size):
                v = torch.as_tensor(videos[i:i + batch_size]).to(device)
                t = torch.as_tensor(texts[i:i + batch_size]).to(
                    device=device, dtype=torch.long)
                img, txt, _ = self.model(v.float(), t)
                vids.append(img.cpu().numpy())
                txts.append(txt.cpu().numpy())
        self.model.train(was_training)
        return np.concatenate(vids, 0), np.concatenate(txts, 0)

    def evaluate(self, videos, texts, rel_matrix: np.ndarray,
                 batch_size: int = 8,
                 text_index: Optional[np.ndarray] = None) -> Dict[str, float]:
        """mAP and nDCG of the evaluation set, video to text and text to
        video, against ``rel_matrix`` (n_videos, n_texts). ``text_index``
        reindexes the text columns (upstream's selection of unique
        captions)."""
        vid_emb, txt_emb = self.encode_dataset(videos, texts, batch_size)
        sim = (vid_emb @ txt_emb.T + 1) / 2
        if text_index is not None:
            sim = sim[:, text_index]
        v_map, t_map, avg_map = get_mAP(sim, rel_matrix)
        v_ndcg, t_ndcg, avg_ndcg = get_nDCG(sim, rel_matrix)
        return dict(vis_map=v_map, txt_map=t_map, avg_map=avg_map,
                    vis_ndcg=v_ndcg, txt_ndcg=t_ndcg, avg_ndcg=avg_ndcg)

    def state_dict(self):
        return dict(params=self.model.state_dict())

    def load_state_dict(self, state):
        self.model.load_state_dict(state["params"])


def build_clip_mir(config=CLIP_TIMEMAMBA_B_EK100_MIR, device="cuda",
                   seed: int = 0, attn_flash=None,
                   vision_dtype: Optional[torch.dtype] = None
                   ) -> MirFinetuner:
    """A ``MirFinetuner`` holding the ``CLIP`` of ``config`` (default
    CLIP-TimeMamba-B at the EK100 MIR preset's widths) with random weights
    from ``seed``, on ``device`` ("cuda" unless the caller asks for "cpu").
    ``attn_flash`` is the video tower's spatial attention kernel (None: the
    einsum path; "row": K10) and ``vision_dtype`` its compute dtype (None:
    fp32); the text tower runs in fp32."""
    m = config["model"]
    vision_cfg = dict(m["vision_cfg"])
    if vision_dtype is not None:
        vision_cfg["dtype"] = vision_dtype
    if attn_flash is not None:
        vision_cfg["attn_flash"] = attn_flash
    return MirFinetuner(CLIP(
        embed_dim=m["embed_dim"], vision_tower=m["vision_tower"],
        vision_cfg=vision_cfg, text_cfg=dict(m["text_cfg"]), device=device,
        seed=seed))
