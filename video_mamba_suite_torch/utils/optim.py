"""Optimizer factory (the port's copy of the JAX package's
``utils/optim.py``): AdamW, Adam or SGD from ``torch.optim``, with the
no-weight-decay rule as parameter groups and optional clipping by the
global gradient norm.

The JAX package builds optax chains; each branch here computes the same
update:
  adamw  optax.adamw (decoupled decay lr·wd·p, bias-corrected moments)
         = torch.optim.AdamW; the mask becomes a group with decay 0.
  adam   optax.chain(add_decayed_weights(wd), adam) = torch.optim.Adam
         with weight_decay (wd·p added to the gradient).
  sgd    optax.chain(add_decayed_weights(wd), sgd(momentum))
         = torch.optim.SGD with momentum and weight_decay.
  grad_clip  optax.clip_by_global_norm, applied before the step.

``chain_step`` is the recognition trainer's chain as one function, in the
JAX order: clip by the global norm, scale each gradient by its layer-decay
factor, then the optimizer's step (AdamW at the schedule's rate).
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import torch
from torch import nn

# parameter leaf names that never get weight decay (the JAX package's list;
# torch's LayerNorm ``weight`` is its ``scale`` and is 1-D, so the 1-D rule
# covers it)
NO_DECAY_NAMES = (
    "A_log", "D", "dt_bias", "bias", "conv_bias", "norm_w", "norm_b",
    "scale", "embedding", "pos_embed", "cls_token", "temporal_embed",
    "scan_norm_w", "norm_f_w", "norm_f_b", "logit_scale", "rel_pe",
)


def no_weight_decay_mask(model: nn.Module) -> Dict[str, bool]:
    """Parameter name → True where weight decay applies: not for a name
    whose last component is or ends with one of ``NO_DECAY_NAMES``, nor for
    a parameter with at most one dimension."""
    mask = {}
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        mask[name] = not (any(leaf == n or leaf.endswith(n)
                              for n in NO_DECAY_NAMES) or p.dim() <= 1)
    return mask


def _clip_grad_norm(params, max_norm: float) -> None:
    """optax.clip_by_global_norm: scale every gradient by
    max_norm / global_norm when the global norm exceeds max_norm."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    norm = torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm([g.float() for g in grads])))
    scale = torch.where(norm > max_norm, max_norm / norm, 1.0)
    torch._foreach_mul_(grads, scale.to(grads[0].dtype))


def chain_step(optimizer: torch.optim.Optimizer,
               named_params: Iterable, grad_scales: Dict[str, float],
               max_norm: float) -> None:
    """One update of the JAX recognition trainer's optax chain
    ``chain(clip_by_global_norm(max_norm), scale_by_layer_decay,
    adamw(schedule))``, in that order:

      1. clip the gradients by their global norm ``max_norm``;
      2. multiply each parameter's gradient by ``grad_scales[name]``, its
         layer-decay factor. The JAX chain scales the gradients before
         Adam, not the learning rate as upstream's per-group rates do, so
         the factor acts mostly through Adam's eps; this is the rule kept
         here;
      3. ``optimizer.step()``: AdamW at each group's current rate, with
         decoupled weight decay on the decayed group."""
    named = [(n, p) for n, p in named_params if p.grad is not None]
    _clip_grad_norm([p for _, p in named], max_norm)
    by_scale: Dict[float, list] = {}
    for name, p in named:
        scale = grad_scales.get(name, 1.0)
        if scale != 1.0:
            by_scale.setdefault(scale, []).append(p.grad)
    for scale, grads in by_scale.items():
        torch._foreach_mul_(grads, scale)
    optimizer.step()


def make_optimizer(
    model: nn.Module,
    name: str = "adamw",
    lr: float = 1e-3,
    weight_decay: float = 0.0,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    momentum: float = 0.9,
    grad_clip: Optional[float] = None,
    use_mask: bool = False,
) -> torch.optim.Optimizer:
    """The optimizer over ``model``'s parameters. ``use_mask`` takes the
    no-weight-decay rule for adamw (the JAX ``params_for_mask``); adam and
    sgd decay every parameter, as there. ``lr`` is a constant."""
    params = list(model.parameters())
    if name == "adamw":
        if use_mask and weight_decay:
            mask = no_weight_decay_mask(model)
            named = list(model.named_parameters())
            groups = [
                {"params": [p for n, p in named if mask[n]],
                 "weight_decay": weight_decay},
                {"params": [p for n, p in named if not mask[n]],
                 "weight_decay": 0.0},
            ]
        else:
            groups = [{"params": params, "weight_decay": weight_decay}]
        opt = torch.optim.AdamW(groups, lr=lr, betas=(b1, b2), eps=eps)
    elif name == "adam":
        opt = torch.optim.Adam(params, lr=lr, betas=(b1, b2), eps=eps,
                               weight_decay=weight_decay)
    elif name == "sgd":
        opt = torch.optim.SGD(params, lr=lr, momentum=momentum,
                              weight_decay=weight_decay)
    else:
        raise ValueError(f"unknown optimizer {name!r}")
    if grad_clip:
        opt.register_step_pre_hook(
            lambda o, args, kwargs: _clip_grad_norm(params, grad_clip))
    return opt
