"""Operators of the PyTorch port: plain versions and hand-written kernels.

Nothing here builds or loads a kernel at import time; a kernel is compiled
with nvcc the first time a CUDA tensor reaches its wrapper.
"""

from ._build import LAUNCHES, reset_launches
from .causal_conv1d import causal_conv1d, causal_conv1d_update
from .flash_attention import (
    FlashMHA,
    flash_mha,
    flash_mha_bwd,
    flash_mha_bwd_ref,
    flash_mha_fwd,
    flash_mha_ref,
)
from .mamba_inner import MASKED_DELTA, mamba_inner, mamba_inner_bidir
from .norms import fused_add_norm, layer_norm, rms_norm
from .selective_scan import selective_scan, selective_scan_ref
from .selective_scan_bidir import (
    selective_scan_bidir,
    selective_scan_bidir_bwd,
    selective_scan_bidir_bwd_ref,
    selective_scan_bidir_ref,
)
from .selective_scan_complex import (
    ComplexChunkedScan,
    complex_scan_bwd,
    complex_scan_bwd_ref,
    complex_scan_fwd,
    complex_scan_fwd_ref,
)
from .selective_scan_chunked import (
    CHECKPOINT_STEPS,
    chunked_scan_bwd,
    chunked_scan_bwd_ref,
    chunked_scan_fwd,
    chunked_scan_states_ref,
)
from .selective_scan_short import (
    SHORT_SEQ_MAX,
    ShortScan,
    short_scan_bwd,
    short_scan_bwd_ref,
    short_scan_fwd,
    short_scan_fwd_ref,
    use_short_scan,
)
from .selective_state_update import selective_state_update
from .vision_attention import (
    MAX_ROW_TOKENS,
    row_mha_fwd,
    row_mha_qkv,
    row_mha_qkv_ref,
    vision_mha,
    vision_mha_fwd,
    vision_mha_ref,
)

__all__ = [
    "CHECKPOINT_STEPS", "ComplexChunkedScan", "FlashMHA", "LAUNCHES",
    "MASKED_DELTA", "MAX_ROW_TOKENS",
    "SHORT_SEQ_MAX",
    "ShortScan",
    "causal_conv1d", "causal_conv1d_update",
    "chunked_scan_bwd", "chunked_scan_bwd_ref", "chunked_scan_fwd",
    "chunked_scan_states_ref", "complex_scan_bwd", "complex_scan_bwd_ref",
    "complex_scan_fwd", "complex_scan_fwd_ref", "flash_mha",
    "flash_mha_bwd", "flash_mha_bwd_ref", "flash_mha_fwd", "flash_mha_ref",
    "fused_add_norm",
    "layer_norm", "mamba_inner", "mamba_inner_bidir", "reset_launches",
    "rms_norm", "selective_scan", "selective_scan_bidir",
    "selective_scan_bidir_bwd", "selective_scan_bidir_bwd_ref",
    "selective_scan_bidir_ref", "selective_scan_ref",
    "selective_state_update", "short_scan_bwd", "short_scan_bwd_ref",
    "row_mha_fwd", "row_mha_qkv", "row_mha_qkv_ref",
    "short_scan_fwd", "short_scan_fwd_ref",
    "use_short_scan", "vision_mha", "vision_mha_fwd", "vision_mha_ref",
]
