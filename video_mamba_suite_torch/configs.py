"""Model widths the port supports (its own copy of the JAX package's
``configs/presets.py`` entries it needs)."""

from __future__ import annotations

# TimeMamba-B video encoder: ViT-B/16 with ViM temporal adapters, 16 frames
# at 224², CLIP-style pre-LN, projected to 512 (the egocentric CLIP tower).
TIMEMAMBA_B = dict(
    img_size=224, patch_size=16, embed_dim=768, depth=12, num_heads=12,
    num_frames=16, ln_pre=True, output_dim=512,
)

# ViViM-T for Kinetics-400 recognition (the JAX package's preset
# ``recognition_k400_vivim_tiny``): 16 frames at 224², patch 16, so
# 16 x 197 = 3152 tokens through 24 ViM layers of width 192; 400 classes.
VIVIM_T_K400 = dict(
    img_size=224, patch_size=16, num_frames=16, depth=24, embed_dim=192,
    num_classes=400, drop_path_rate=0.1,
)
# Its fine-tuning recipe (the preset's ``opt`` and ``aug``, as the keyword
# arguments of ``RecognitionTrainer``): layer-decayed AdamW with EMA,
# mixup and cutmix with label smoothing. The preset's RandAugment and
# random erasing belong to the data pipeline, which is not ported.
VIVIM_T_K400_FINETUNE = dict(
    lr=1e-3, weight_decay=0.05, layer_decay=0.75, ema_decay=0.9999,
    mixup_alpha=0.8, cutmix_alpha=1.0, smoothing=0.1,
)
# ViViM-S (``recognition_k400_vivim_small``): width 384.
VIVIM_S_K400 = dict(VIVIM_T_K400, embed_dim=384)

# Mamba-130M language model: the published widths of state-spaces/mamba-130m
# (its config.json): d_model 768, 24 layers, vocabulary 50277 padded to a
# multiple of 8, ssm_cfg {} (d_state 16, d_conv 4, expand 2), RMSNorm, the
# residual stream in fp32. ``fused_add_norm`` picks upstream's fused kernel
# for the same arithmetic; the port always adds and norms in one step.
MAMBA_130M = dict(
    d_model=768, n_layer=24, vocab_size=50277, ssm_cfg={}, rms_norm=True,
    residual_in_fp32=True, fused_add_norm=True, pad_vocab_size_multiple=8,
)

# Action anticipation on EPIC-KITCHENS-100 (the JAX package's preset
# ``anticipation_ek100``, TeSTra's MODEL.LSTR with Mamba layers): 512
# long-memory + 32 work-memory frames and 4 anticipation queries, so one
# causal scan of 548 tokens through 2 layers of width 1024; 3807 action
# classes; classifier dropout 0.2; AdamW lr 7e-5, weight decay 5e-5;
# batch 16. The JAX preset leaves the input widths to the data: 1024 each
# are the BN-Inception RGB and optical-flow features of TeSTra's EK100
# configs.
ANTICIPATION_EK100 = dict(
    model=dict(visual_dim=1024, motion_dim=1024, d_model=1024,
               mamba_layers=2, long_memory_num_samples=512,
               work_memory_num_samples=32, anticipation_num_samples=4,
               num_classes=3807, dropout_cls=0.2),
    opt=dict(lr=7e-5, weight_decay=5e-5),
    batch_size=16,
)
# The same widths and recipe with the long memory cut from 512 to 28
# frames, for the short kernels: 28 + 32 + 4 = 64 tokens take K5 forward
# and K6 backward.
ANTICIPATION_EK100_SHORT = dict(
    ANTICIPATION_EK100,
    model=dict(ANTICIPATION_EK100["model"], long_memory_num_samples=28),
)

# EK100 multi-instance retrieval on CLIP-TimeMamba-B: the JAX package's
# preset ``ego_ek100_mir`` (configs/presets.py:127-134) as its CLI builds it
# (``_build_ego_clip``, cli.py:788-812): video tower TimeMamba-B, 16 frames
# at 224², patch 16, width 768, 12 layers, 12 heads, ln_pre, frozen-in-time,
# tanh-gated adapters; embeddings of 512; text tower context 77, CLIP's BPE
# vocabulary of 49408, width 512, 8 heads, 12 layers. The preset's recipe
# (upstream main_lavila_finetune_mir.py's defaults: lr 1e-5, weight decay
# 0.01, batch 64) is for the fine-tuning step.
CLIP_TIMEMAMBA_B_EK100_MIR = dict(
    model=dict(
        embed_dim=512, vision_tower="timemamba",
        vision_cfg=dict(img_size=224, patch_size=16, embed_dim=768, depth=12,
                        num_heads=12, num_frames=16, ln_pre=True,
                        attention_style="frozen-in-time",
                        is_tanh_gating=True),
        text_cfg=dict(context_length=77, vocab_size=49408, width=512,
                      heads=8, layers=12)),
    opt=dict(lr=1e-5, weight_decay=0.01),
    batch_size=64,
)
