"""Models of the PyTorch port."""

from .clip import (
    CLIP,
    ClipImageTower,
    ResidualAttentionBlock,
    TextTransformer,
    clip_timemamba_base,
    clip_timemamba_frozen,
    clip_timemamba_frozen_joint,
    clip_vivim_small,
    clip_vivim_tiny,
    clip_vivim_tiny_hs4,
)
from .common import (
    AffineDropPath,
    Dense,
    Embedding,
    FusedMHA,
    LayerNorm,
    LayerNorm1D,
    MaskedConv1D,
    MaskMambaBlock,
    PatchifyConv,
    W8Dense,
    W8Embed,
    instance_norm_1d,
    max_pool_1d,
    sinusoid_positions,
    sliding_window_attention,
)
from .convert import (
    causal_mixer_from_jax,
    causal_mixer_from_state_dict,
    clip_from_jax,
    clip_from_state_dict,
    clip_image_tower_from_jax,
    clip_image_tower_from_state_dict,
    dbm_mixer_from_jax,
    inflate_pos_embed,
    inflate_temporal_embed,
    lstr_mamba_from_jax,
    mamba_lm_from_jax,
    mask_mamba_block_from_jax,
    pdvc_from_jax,
    quantized_lm_from_jax,
    tal_detector_from_jax,
    tas_from_jax,
    text_transformer_from_jax,
    text_transformer_from_state_dict,
    timemamba_from_jax,
    timemamba_from_state_dict,
    video_classifier_from_jax,
    vim_mixer_from_jax,
    vim_mixer_from_state_dict,
    vivim_from_jax,
    vivim_from_state_dict,
    vtg_from_jax,
)
from .generation import GenerationConfig, generate, sample_logits
from .hf import (
    dbm_mixer_from_state_dict,
    from_pretrained,
    load_state_dict,
    mamba_lm_from_state_dict,
)
from .lm_eval import (
    MambaHarnessLM,
    perplexity,
    register,
    sequence_loglikelihood,
)
from .mamba import (
    Block,
    MambaCausal,
    MambaDBM,
    MambaScanNorm,
    MambaVim,
    make_block,
)
from .mixer_seq import MambaLMHeadModel, MixerModel, build_mamba_lm
from .quant_decode import quantize_lm_for_decode
from .rope import rope_rotate
from .timemamba import Mlp, SpaceTimeBlock, TimeMamba, build_timemamba_b
from .vivim import (
    PatchEmbed,
    ViViM,
    build_vivim_tiny_k400,
    vivim_small,
    vivim_tiny,
)

__all__ = [
    "causal_mixer_from_state_dict", "clip_from_state_dict",
    "clip_image_tower_from_state_dict", "inflate_pos_embed",
    "inflate_temporal_embed", "instance_norm_1d", "load_state_dict",
    "sliding_window_attention", "tas_from_jax",
    "text_transformer_from_state_dict", "timemamba_from_state_dict",
    "vim_mixer_from_state_dict", "vivim_from_state_dict",
    "MambaHarnessLM", "W8Dense", "W8Embed", "perplexity",
    "quantize_lm_for_decode", "quantized_lm_from_jax", "register",
    "pdvc_from_jax", "rope_rotate", "vtg_from_jax",
    "sequence_loglikelihood", "video_classifier_from_jax",
    "AffineDropPath", "LayerNorm1D", "MambaDBM", "MaskMambaBlock",
    "MaskedConv1D", "dbm_mixer_from_jax", "dbm_mixer_from_state_dict",
    "mask_mamba_block_from_jax", "max_pool_1d", "tal_detector_from_jax",
    "CLIP", "ClipImageTower", "ResidualAttentionBlock", "TextTransformer",
    "clip_from_jax", "clip_image_tower_from_jax", "clip_timemamba_base",
    "clip_timemamba_frozen", "clip_timemamba_frozen_joint",
    "clip_vivim_small", "clip_vivim_tiny", "clip_vivim_tiny_hs4",
    "text_transformer_from_jax",
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
