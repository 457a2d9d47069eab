"""Training utilities of the PyTorch port."""

from .checkpoint import latest_step, restore_checkpoint, save_checkpoint
from .config import Config, load_config
from .ema import ModelEma
from .logging import MetricLogger
from .meters import AverageMeter
from .optim import NO_DECAY_NAMES, chain_step, make_optimizer, \
    no_weight_decay_mask
from .preemption import PreemptionWatcher
from .profiling import StepTimer, live_memory_bytes, trace
from .schedules import ReduceLROnPlateau, lambda_lr, make_schedule
from .trainer import Checkpointing, TrainerCore

__all__ = ["AverageMeter", "Checkpointing", "Config", "MetricLogger",
           "ModelEma", "NO_DECAY_NAMES", "PreemptionWatcher",
           "ReduceLROnPlateau", "StepTimer", "TrainerCore", "chain_step",
           "lambda_lr", "latest_step", "live_memory_bytes", "load_config",
           "make_optimizer", "make_schedule", "no_weight_decay_mask",
           "restore_checkpoint", "save_checkpoint", "trace"]
