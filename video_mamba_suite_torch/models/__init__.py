"""Models of the PyTorch port."""

from .common import Dense, FusedMHA, LayerNorm, PatchifyConv
from .convert import timemamba_from_jax, vim_mixer_from_jax, vivim_from_jax
from .mamba import MambaScanNorm, MambaVim
from .timemamba import Mlp, SpaceTimeBlock, TimeMamba, build_timemamba_b
from .vivim import (
    PatchEmbed,
    ViViM,
    build_vivim_tiny_k400,
    vivim_small,
    vivim_tiny,
)

__all__ = [
    "Dense", "FusedMHA", "LayerNorm", "MambaScanNorm", "MambaVim", "Mlp",
    "PatchEmbed", "PatchifyConv", "SpaceTimeBlock", "TimeMamba", "ViViM",
    "build_timemamba_b", "build_vivim_tiny_k400", "timemamba_from_jax",
    "vim_mixer_from_jax", "vivim_from_jax", "vivim_small", "vivim_tiny",
]
