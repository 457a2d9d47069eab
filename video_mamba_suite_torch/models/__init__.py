"""Models of the PyTorch port."""

from .common import (
    Dense,
    Embedding,
    FusedMHA,
    LayerNorm,
    PatchifyConv,
    sinusoid_positions,
)
from .convert import (
    causal_mixer_from_jax,
    lstr_mamba_from_jax,
    mamba_lm_from_jax,
    timemamba_from_jax,
    vim_mixer_from_jax,
    vivim_from_jax,
)
from .generation import GenerationConfig, generate, sample_logits
from .hf import from_pretrained, mamba_lm_from_state_dict
from .mamba import Block, MambaCausal, MambaScanNorm, MambaVim, make_block
from .mixer_seq import MambaLMHeadModel, MixerModel, build_mamba_lm
from .timemamba import Mlp, SpaceTimeBlock, TimeMamba, build_timemamba_b
from .vivim import (
    PatchEmbed,
    ViViM,
    build_vivim_tiny_k400,
    vivim_small,
    vivim_tiny,
)

__all__ = [
    "Block", "Dense", "Embedding", "FusedMHA", "GenerationConfig", "LayerNorm",
    "MambaCausal", "MambaLMHeadModel", "MambaScanNorm", "MambaVim",
    "MixerModel", "Mlp", "PatchEmbed", "PatchifyConv", "SpaceTimeBlock",
    "TimeMamba", "ViViM", "build_mamba_lm", "build_timemamba_b",
    "build_vivim_tiny_k400", "causal_mixer_from_jax", "from_pretrained",
    "generate", "lstr_mamba_from_jax", "make_block", "mamba_lm_from_jax",
    "mamba_lm_from_state_dict", "sample_logits", "sinusoid_positions",
    "timemamba_from_jax", "vim_mixer_from_jax", "vivim_from_jax",
    "vivim_small", "vivim_tiny",
]
