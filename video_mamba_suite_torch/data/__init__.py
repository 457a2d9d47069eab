"""Data utilities of the PyTorch port."""

from .sampler import sharded_epoch_order

__all__ = ["sharded_epoch_order"]
