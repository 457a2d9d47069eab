"""Training utilities of the PyTorch port."""

from .optim import NO_DECAY_NAMES, make_optimizer, no_weight_decay_mask

__all__ = ["NO_DECAY_NAMES", "make_optimizer", "no_weight_decay_mask"]
