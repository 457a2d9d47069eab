"""Training utilities of the PyTorch port."""

from .ema import ModelEma
from .optim import NO_DECAY_NAMES, chain_step, make_optimizer, \
    no_weight_decay_mask
from .schedules import ReduceLROnPlateau, lambda_lr, make_schedule

__all__ = ["ModelEma", "NO_DECAY_NAMES", "ReduceLROnPlateau", "chain_step",
           "lambda_lr", "make_optimizer", "make_schedule",
           "no_weight_decay_mask"]
