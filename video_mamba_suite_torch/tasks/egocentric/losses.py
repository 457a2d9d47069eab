"""Losses of CLIP pretraining and MIR fine-tuning (counterparts of the JAX
package's ``tasks/egocentric/losses.py``): the symmetric InfoNCE of
``clip_loss`` and the max-margin ranking loss. Plain functions on tensors.

On one card ``clip_loss`` takes the whole batch. The JAX package's
``sharded_clip_loss`` (features gathered over a data-parallel mesh) needs
the port's distributed layer, which does not exist yet.
"""

from __future__ import annotations

import torch


def _ce_with_diag_labels(logits: torch.Tensor,
                         label_offset: int = 0) -> torch.Tensor:
    """Cross entropy of each row i against label i + ``label_offset``,
    averaged over the rows."""
    n = logits.shape[0]
    rows = torch.arange(n, device=logits.device)
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(logp[rows, rows + label_offset])


def clip_loss(image_features: torch.Tensor, text_features: torch.Tensor,
              logit_scale: torch.Tensor) -> torch.Tensor:
    """Symmetric InfoNCE over the batch: the mean of the cross entropies of
    ``logit_scale`` · image @ text^T by rows and by columns, clip i
    matching caption i. The features must be L2-normalised."""
    logits_per_image = logit_scale * image_features @ text_features.T
    return 0.5 * (_ce_with_diag_labels(logits_per_image)
                  + _ce_with_diag_labels(logits_per_image.T))


def max_margin_ranking_loss(sim_matrix: torch.Tensor,
                            margin: float = 0.2) -> torch.Tensor:
    """Hinge max(0, margin + s_ij - s_ii) over the off-diagonal pairs, in
    both directions (against the row's and the column's matched pair),
    summed and divided by n · max(n - 1, 1) · 2."""
    n = sim_matrix.shape[0]
    diag = torch.diagonal(sim_matrix)
    eye = torch.eye(n, dtype=torch.bool, device=sim_matrix.device)
    cost_im = torch.clamp_min(margin + sim_matrix - diag[:, None], 0.0)
    cost_txt = torch.clamp_min(margin + sim_matrix - diag[None, :], 0.0)
    cost_im = cost_im.masked_fill(eye, 0.0)
    cost_txt = cost_txt.masked_fill(eye, 0.0)
    return (cost_im.sum() + cost_txt.sum()) / (n * max(n - 1, 1) * 2)
