"""Data utilities of the PyTorch port."""

from .sampler import sharded_epoch_order
from .tokenizer import WordTokenizer, tokenize, whitespace_clean

__all__ = ["WordTokenizer", "sharded_epoch_order", "tokenize",
           "whitespace_clean"]
