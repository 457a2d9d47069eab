"""Query-focused video summarization on UniVTG-Mamba (the port's
counterpart of the JAX package's ``tasks/vtg/qfvs.py``; upstream
main/train_qfvs.py, main/dataset_qfvs.py and eval/qfvs.py): the three
concept forwards of a step (concept 1, concept 2, and both as the oracle
query) with their losses summed under ``loss_gather``, the top-p% shot
selection, and the semantic-IoU matching P/R/F1 against concept tags.

The per-segment (segments × frames) layout is flattened to one (B, S·F)
sequence with a validity mask. Max-weight matching uses scipy's
``linear_sum_assignment`` (the weights are non-negative IoUs, so the
rectangular assignment's optimum equals networkx's max-weight matching).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .train import UniVtgTrainer


# --- metric (upstream eval/qfvs.py) -----------------------------------------


def semantic_iou(a: np.ndarray, b: np.ndarray) -> float:
    """IoU of binary concept-tag vectors (upstream eval/qfvs.py:32-40)."""
    inter = float(np.sum(a * b))
    union = float(np.sum((a + b) > 0))
    return inter / union if union else 0.0


def calculate_semantic_matching(machine_summary: Sequence[int],
                                gt_summary: Sequence[int],
                                shots_tag: np.ndarray):
    """P/R/F1 via max-weight bipartite matching of shot concept-tags
    (upstream eval/qfvs.py:57-75). shots_tag: (n_shots, n_concepts) binary."""
    from scipy.optimize import linear_sum_assignment

    m_mat = shots_tag[np.asarray(machine_summary, int)]
    g_mat = shots_tag[np.asarray(gt_summary, int)]
    w = np.zeros((len(m_mat), len(g_mat)))
    for i in range(len(m_mat)):
        for j in range(len(g_mat)):
            w[i, j] = semantic_iou(m_mat[i], g_mat[j])
    ri, ci = linear_sum_assignment(-w)
    total = float(w[ri, ci].sum())
    precision = total / max(len(m_mat), 1)
    recall = total / max(len(g_mat), 1)
    f1 = (2 * precision * recall / (precision + recall)
          if precision + recall else 0.0)
    return precision, recall, f1


# --- losses ------------------------------------------------------------------


def qfvs_losses(out: Dict[str, torch.Tensor], gt: torch.Tensor,
                mask: torch.Tensor, f_loss_coef: float = 1.0,
                s_loss_intra_coef: float = 0.1, margin: float = 0.2
                ) -> Dict[str, torch.Tensor]:
    """Frame classification and intra-video saliency ranking. gt / mask
    (B, L) binary summary labels / validity. loss_f: the masked
    ``optax.sigmoid_binary_cross_entropy`` of pred_logits (the model's
    probabilities, taken as logits, as the JAX package does); loss_s_intra:
    the hinge ``margin`` - mean positive saliency + mean negative
    saliency; loss_total = f_loss_coef · loss_f + s_loss_intra_coef ·
    loss_s_intra."""
    logits = out["pred_logits"][..., 0].float()
    m, gtf = mask.float(), gt.float()
    bce = F.binary_cross_entropy_with_logits(logits, gtf, reduction="none")
    loss_f = (bce * m).sum() / m.sum().clamp_min(1.0)
    sal = out["saliency_scores"].float()
    pos, neg = gtf * m, (1.0 - gtf) * m
    pos_mean = (sal * pos).sum(-1) / pos.sum(-1).clamp_min(1.0)
    neg_mean = (sal * neg).sum(-1) / neg.sum(-1).clamp_min(1.0)
    loss_s = (margin - pos_mean + neg_mean).clamp_min(0.0).mean()
    total = f_loss_coef * loss_f + s_loss_intra_coef * loss_s
    return dict(loss_f=loss_f, loss_s_intra=loss_s, loss_total=total)


# --- synthetic data (the dataset_qfvs.py contract on random tensors) ---------


def make_synthetic_qfvs(num_items: int = 4, n_segments: int = 3,
                        n_frames: int = 8, vid_dim: int = 12,
                        txt_dim: int = 12, n_concepts: int = 6, seed: int = 0):
    """Items shaped like dataset_qfvs.py's: segmented features, two concept
    embeddings, per-frame oracle summary labels, segment lengths."""
    rng = np.random.default_rng(seed)
    items = []
    for _ in range(num_items):
        seg_len = rng.integers(n_frames // 2, n_frames + 1, n_segments)
        feats = rng.standard_normal(
            (n_segments, n_frames, vid_dim)).astype(np.float32)
        c1 = rng.standard_normal((txt_dim,)).astype(np.float32)
        c2 = rng.standard_normal((txt_dim,)).astype(np.float32)
        gt = np.zeros((n_segments, n_frames), np.float32)
        for s in range(n_segments):
            k = max(1, int(seg_len[s]) // 3)
            gt[s, rng.choice(seg_len[s], k, replace=False)] = 1.0
        items.append(dict(features=feats, seg_len=seg_len,
                          concept1=c1, concept2=c2, gt_summary=gt))
    shots_tag = (rng.random((n_segments * n_frames * 2, n_concepts))
                 > 0.6).astype(np.float64)
    return items, shots_tag


def collate_qfvs(items: List[dict]):
    """Flatten segments → (B, S·F) sequences + masks (in place of upstream
    start_end_collate_qfvs / prepare_batch_inputs_qfvs): (features,
    mask, gt, concept1 (B, 1, Dt), concept2)."""
    feats = np.stack([it["features"] for it in items])       # (B,S,F,D)
    B, S, F, D = feats.shape
    mask = np.zeros((B, S, F), np.float32)
    for b, it in enumerate(items):
        for s, sl in enumerate(it["seg_len"]):
            mask[b, s, :sl] = 1.0
    gt = np.stack([it["gt_summary"] for it in items])
    c1 = np.stack([it["concept1"] for it in items])[:, None]  # (B,1,Dt)
    c2 = np.stack([it["concept2"] for it in items])[:, None]
    return (feats.reshape(B, S * F, D), mask.reshape(B, S * F),
            gt.reshape(B, S * F), c1, c2)


class QfvsTrainer(UniVtgTrainer):
    """The JAX ``QfvsTrainer``: a ViM ``UniVTGMamba`` without input dropout
    (drop-path the model's 0.1), AdamW without clipping, three concept
    forwards a step, and the top-p% summary. Builds on ``device``, CUDA
    unless the caller passes "cpu". ``save`` checkpoints the trainer's
    state (the JAX trainer has no ``restore``)."""

    def __init__(self, txt_dim: int, vid_dim: int, embed_dim: int = 32,
                 depth: int = 2, lr: float = 1e-4, weight_decay: float = 1e-4,
                 f_loss_coef: float = 1.0, s_loss_intra_coef: float = 0.1,
                 loss_gather: bool = True, score_gather: bool = True,
                 top_percent: float = 0.15, use_mesh: bool = False,
                 seed: int = 0, device="cuda"):
        super().__init__(dict(txt_dim=txt_dim, vid_dim=vid_dim,
                              embed_dim=embed_dim, depth=depth,
                              input_dropout=0.0),
                         lr, weight_decay, None, seed, device, use_mesh)
        self.coefs = (f_loss_coef, s_loss_intra_coef)
        self.loss_gather, self.score_gather = loss_gather, score_gather
        self.top_percent = top_percent

    def save(self, directory: str, step: int) -> None:
        """Checkpoint the trainer's state as ``step``."""
        self.core.save(directory, step, self.state_dict())

    def _query(self, vid, vmask, txt, train: bool = False) -> Dict:
        """The model on video features, their mask and a query (B, Lq,
        Dt) of valid tokens."""
        batch = dict(src_txt=txt, src_txt_mask=np.ones(txt.shape[:2],
                                                        np.float32),
                     src_vid=vid, src_vid_mask=vmask)
        return self.forward(batch, train=train)

    def train_step(self, vid, vmask, gt, c1, c2,
                   deterministic: bool = False) -> Dict[str, float]:
        """One step on a ``collate_qfvs`` batch: the forwards with concept
        1, concept 2 and both (the oracle), each with drop-path (none with
        ``deterministic``), their ``qfvs_losses`` summed (the oracle's
        alone without ``loss_gather``), the backward and the AdamW update.
        Returns the total and the oracle's terms, read from the device
        once."""
        oracle = np.concatenate([np.asarray(c1), np.asarray(c2)], axis=1)
        gt_t, m_t = (torch.as_tensor(a).to(self.device) for a in (gt, vmask))
        terms = [qfvs_losses(self._query(vid, vmask, q, not deterministic),
                             gt_t, m_t, *self.coefs)
                 for q in (c1, c2, oracle)]
        lo = terms[-1]
        total = (sum(t["loss_total"] for t in terms) if self.loss_gather
                 else lo["loss_total"])
        self.apply_gradients(total)
        values = torch.stack([total.detach(), lo["loss_f"].detach(),
                              lo["loss_s_intra"].detach()]).cpu().tolist()
        return dict(zip(("loss_total", "loss_f", "loss_s_intra"), values))

    def _scores(self, vid, vmask, txt) -> np.ndarray:
        """(probabilities, saliency) of one eval forward, on the host."""
        with torch.inference_mode():
            out = self._query(vid, vmask, txt)
            both = torch.stack([out["pred_logits"][..., 0],
                                out["saliency_scores"]])
            return both.float().cpu().numpy()

    def predict_summary(self, vid, vmask, c1, c2) -> List[np.ndarray]:
        """Each video's top-p% frame indices by probability + saliency,
        summed over the oracle's forward and (with ``score_gather``) the
        two concepts' (upstream eval_epoch :104-141)."""
        oracle = np.concatenate([np.asarray(c1), np.asarray(c2)], axis=1)
        logit_o, sal_o = self._scores(vid, vmask, oracle)
        score = logit_o + sal_o
        if self.score_gather:
            for cc in (c1, c2):
                lg, sl = self._scores(vid, vmask, cc)
                score = score + lg + sl
        picks = []
        for b in range(score.shape[0]):
            valid = np.asarray(vmask[b]) > 0
            k = max(1, int(int(valid.sum()) * self.top_percent))
            s = np.where(valid, score[b], -np.inf)
            picks.append(np.argsort(-s)[:k])
        return picks

    def evaluate(self, items: List[dict], shots_tag: np.ndarray
                 ) -> Dict[str, float]:
        """P, R and F (percent) of each item's summary against its oracle
        frames by ``calculate_semantic_matching``, averaged over items."""
        vid, vmask, gt, c1, c2 = collate_qfvs(items)
        picks = self.predict_summary(vid, vmask, c1, c2)
        p_sum = r_sum = f_sum = 0.0
        for b in range(len(items)):
            gt_idx = np.nonzero(gt[b] > 0)[0]
            p, r, f1 = calculate_semantic_matching(
                picks[b].tolist(), gt_idx.tolist(), shots_tag)
            p_sum, r_sum, f_sum = p_sum + p, r_sum + r, f_sum + f1
        n = max(len(items), 1)
        return {"P": 100 * p_sum / n, "R": 100 * r_sum / n,
                "F": 100 * f_sum / n}
