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
# 0.01, batch 64) is for the fine-tuning step, which ``MirFinetuner`` runs
# with AdamW (b2 0.98), a warmup-cosine schedule and clip 1.0.
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

# CLIP pretraining on Ego4D with CLIP-TimeMamba-B: the JAX package's preset
# ``ego_timemamba_pretrain`` (configs/presets.py:113-124, from upstream's
# scripts/pretrain/run_slurm_pretrain_bs512_timemamba_like_frozen.sh):
# the MIR model's widths at 4 frames (frozen-in-time residuals, tanh-gated
# adapters), embeddings of 512, text context 77; AdamW lr 3e-5, weight
# decay 0.01, b2 0.98, cosine schedule, clip 1.0; 5 epochs with 1 of
# warmup; batch 256 over the whole job.
EGO_TIMEMAMBA_PRETRAIN = dict(
    model=dict(CLIP_TIMEMAMBA_B_EK100_MIR["model"],
               vision_cfg=dict(CLIP_TIMEMAMBA_B_EK100_MIR["model"]
                               ["vision_cfg"], num_frames=4)),
    opt=dict(lr=3e-5, weight_decay=0.01),
    epochs=5,
    warmup_epochs=1,
    batch_size=256,
)

# EK100 action classification: the JAX package's preset ``ego_ek100_cls``
# (configs/presets.py:136-145, upstream main_lavila_finetune_cls.py's
# defaults): a ViViM-T backbone (width 192, depth 24, 16 frames at 224²,
# patch 16) without projection under a dropout-0.5 linear head over the
# 3806 EK100 actions; AdamW lr 1e-4, weight decay 0.05, label smoothing
# 0.1, mixup 0.8, cutmix 1.0; 30 epochs; batch 32.
EGO_EK100_CLS = dict(
    model=dict(img_size=224, patch_size=16, num_frames=16, depth=24,
               embed_dim=192),
    num_classes=3806,
    opt=dict(lr=1e-4, weight_decay=0.05),
    aug=dict(smoothing=0.1, mixup_alpha=0.8, cutmix_alpha=1.0),
    epochs=30,
    batch_size=32,
)

# Temporal action localization, ActionMamba on THUMOS-14 (the JAX package's
# preset ``tal_thumos``, from upstream's configs/mamba_thumos_new.yaml):
# InternVideo2 features of 3200 channels every 4 frames (16-frame windows),
# videos cut or padded to 2304 steps, 20 classes; a DBM pyramid of width
# 512, arch (2, 2, 5) (6 levels), identity neck; AdamW 1e-4, weight decay
# 0.05, 45 epochs with 5 of warmup, clip 1.0, EMA 0.999; batch 2.
# ``train_videos`` is the training split's size (THUMOS-14's validation
# set, 200 videos), which sets the steps of an epoch.
TAL_THUMOS = dict(
    dataset=dict(num_classes=20, input_dim=3200, feat_stride=4,
                 num_frames=16, trunc_thresh=0.5, crop_ratio=[0.9, 1.0],
                 max_seq_len=2304, file_ext=".npy", train_videos=200),
    model=dict(backbone_arch=[2, 2, 5], embd_dim=512, fpn_type="identity",
               mixer="dbm", scale_factor=2,
               regression_range=[[0, 4], [4, 8], [8, 16], [16, 32],
                                 [32, 64], [64, 10000]]),
    opt=dict(learning_rate=1e-4, epochs=45, weight_decay=0.05,
             warmup_epochs=5, grad_clip=1.0, ema_decay=0.999),
    loader=dict(batch_size=2),
    train_cfg=dict(init_loss_norm=100, cls_prior_prob=0.01,
                   center_sample="radius", center_sample_radius=1.5,
                   droppath=0.1, label_smoothing=0.0),
    test_cfg=dict(voting_thresh=0.7, pre_nms_topk=2000, max_seg_num=200,
                  min_score=0.001, multiclass_nms=True, nms_sigma=0.5,
                  iou_threshold=0.1, nms_method="soft",
                  duration_thresh=0.05),
)
# ActionMamba on ActivityNet-1.3 (the preset ``tal_anet``): the same
# features every 16 frames, videos resized to 192 steps, one class
# (proposals, labelled by an external classifier at eval); the same
# pyramid, so its levels are 192, 96, 48, 24, 12 and 6 steps; AdamW 1e-3,
# 15 epochs with 5 of warmup; batch 16. The preset gives no train_cfg:
# these are the JAX trainer's defaults. 10024 training videos.
TAL_ANET = dict(
    dataset=dict(num_classes=1, input_dim=3200, feat_stride=16,
                 num_frames=16, max_seq_len=192, trunc_thresh=0.5,
                 crop_ratio=[0.9, 1.0], train_videos=10024),
    model=dict(backbone_arch=[2, 2, 5], embd_dim=512, fpn_type="identity",
               mixer="dbm", scale_factor=2),
    opt=dict(learning_rate=1e-3, epochs=15, weight_decay=0.05,
             warmup_epochs=5, grad_clip=1.0, ema_decay=0.999),
    loader=dict(batch_size=16),
    train_cfg=dict(init_loss_norm=100, cls_prior_prob=0.01,
                   center_sample="radius", center_sample_radius=1.5,
                   droppath=0.1, label_smoothing=0.0),
    test_cfg=dict(multiclass_nms=False, nms_sigma=0.75, max_seg_num=100,
                  voting_thresh=0.9, ext_score_fusion=True),
)

# Temporal action segmentation, ASFormer-Mamba on GTEA (the JAX package's
# preset ``tas_gtea``, upstream temporal-action-segmentation main.py's
# defaults): I3D features of 2048 channels a frame, 11 classes; an encoder
# of 10 masked ViM layers (MaskMambaBlock, d_model 64, drop-path 0.3) and
# 3 attention decoders of 10 layers, 64 feature maps, input channels
# masked at 0.3; Adam 5e-4 with L2 weight decay 1e-5, 120 epochs; one
# whole video a batch.
_TAS_MODEL = dict(num_decoders=3, num_layers=10, num_f_maps=64,
                  input_dim=2048, channel_masking_rate=0.3, mixer="vim")
_TAS_OPT = dict(learning_rate=5e-4, weight_decay=1e-5, epochs=120)
TAS_GTEA = dict(
    model=dict(_TAS_MODEL, drop_path_rate=0.3), opt=dict(_TAS_OPT),
    loader=dict(batch_size=1, sample_rate=1), dataset=dict(num_classes=11),
)
# 50Salads (``tas_50salads``): 19 classes, every 2nd frame of the 30 fps
# features. The drop-path is the model's default 0.3, as in the preset.
TAS_50SALADS = dict(
    model=dict(_TAS_MODEL), opt=dict(_TAS_OPT),
    loader=dict(batch_size=1, sample_rate=2), dataset=dict(num_classes=19),
)
# Breakfast (``tas_breakfast``): 48 classes.
TAS_BREAKFAST = dict(
    model=dict(_TAS_MODEL), opt=dict(_TAS_OPT),
    loader=dict(batch_size=1, sample_rate=1), dataset=dict(num_classes=48),
)

# Video temporal grounding, UniVTG-Mamba on QVHighlights (the JAX package's
# preset ``vtg_qvhighlights``, from upstream main/config.py and
# scripts/qvhl_pretrain_mamba.sh): SlowFast + CLIP video features of 2816
# channels a 2 s clip, CLIP text features of 512 a token; width 1024, 6
# DBM layers, input dropout 0.5, drop-path 0.1; queries padded to 32
# tokens and videos to 75 clips; AdamW 1e-4, weight decay 1e-4, clip 0.1,
# 200 epochs, batch 32; the criterion's weights.
VTG_QVHIGHLIGHTS = dict(
    model=dict(embed_dim=1024, depth=6, mamba_type="dbm",
               input_dropout=0.5, drop_path_rate=0.1,
               max_q_l=32, max_v_l=75, clip_len=2.0),
    dataset=dict(v_feat_dim=2816, t_feat_dim=512),
    opt=dict(learning_rate=1e-4, weight_decay=1e-4, epochs=200,
             grad_clip=0.1),
    loader=dict(batch_size=32),
    loss=dict(loss_b=10.0, loss_g=1.0, loss_f=10.0, loss_s_inter=0.1,
              loss_s_intra=0.1, eos_coef=0.1, temperature=0.07),
)
# Charades-STA (``vtg_charades``): 4096-d video features a 1 s clip.
VTG_CHARADES = dict(
    model=dict(embed_dim=1024, depth=6, mamba_type="dbm",
               input_dropout=0.5, max_q_l=32, max_v_l=75, clip_len=1.0),
    dataset=dict(v_feat_dim=4096, t_feat_dim=512),
    opt=dict(learning_rate=1e-4, weight_decay=1e-4, epochs=100,
             grad_clip=0.1),
    loader=dict(batch_size=32),
)
# TACoS (``vtg_tacos``): SlowFast + CLIP features, videos of up to 128
# clips.
VTG_TACOS = dict(
    model=dict(embed_dim=1024, depth=6, mamba_type="dbm",
               input_dropout=0.5, max_q_l=32, max_v_l=128, clip_len=2.0),
    dataset=dict(v_feat_dim=2816, t_feat_dim=512),
    opt=dict(learning_rate=1e-4, weight_decay=1e-4, epochs=100,
             grad_clip=0.1),
    loader=dict(batch_size=32),
)
# Ego4D-NLQ (``vtg_ego4d``): EgoVLP / InternVideo features of 2304
# channels, videos of up to 255 clips.
VTG_EGO4D = dict(
    model=dict(embed_dim=1024, depth=6, mamba_type="dbm",
               input_dropout=0.5, max_q_l=32, max_v_l=255, clip_len=2.0),
    dataset=dict(v_feat_dim=2304, t_feat_dim=512),
    opt=dict(learning_rate=1e-4, weight_decay=1e-4, epochs=100,
             grad_clip=0.1),
    loader=dict(batch_size=32),
)
# Highlight detection on TVSum (``vtg_tvsum``, upstream train_hl.py and
# config_hl.py): the saliency-only objective on one domain's split,
# videos of up to 512 clips, batch 4, the TVSum top-5 mAP.
VTG_TVSUM = dict(
    model=dict(embed_dim=1024, depth=6, mamba_type="dbm",
               max_v_l=512, clip_len=2.0),
    dataset=dict(v_feat_dim=2816, t_feat_dim=512, domain="BK",
                 highlight=True),
    opt=dict(learning_rate=1e-4, weight_decay=1e-4, epochs=100,
             grad_clip=0.1),
    loader=dict(batch_size=4),
    loss=dict(loss_f=4.0, loss_s_intra=0.1, eos_coef=0.1),
)

# Dense video captioning, PDVC-Mamba on ActivityNet Captions (the JAX
# package's preset ``dvc_anet_c3d``, from upstream cfgs/anet_c3d_pdvc.yml):
# C3D features of 500 channels, one class; width 512, 10 event queries, 4
# levels, 2 ViM encoder and 2 decoder layers; the LSTM-DSA caption head
# ("standard"), captions of up to 30 tokens, counts up to 10 events; AdamW
# 5e-5, weight decay 1e-4, clip 0.1, 30 epochs, batch 1; the criterion's
# weights. ``build_captioning_trainer`` pads videos to the JAX CLI's 256
# features (levels 256, 128, 64 and 32: 480 tokens) and 10 events.
DVC_ANET_C3D = dict(
    model=dict(d_model=512, num_queries=10, n_levels=4,
               num_encoder_layers=2, num_decoder_layers=2,
               max_eseq_length=10, max_caption_len=30, mixer="vim",
               input_dim=500, num_classes=1,
               caption_decoder_type="standard"),
    opt=dict(learning_rate=5e-5, weight_decay=1e-4, epochs=30,
             grad_clip=0.1),
    loader=dict(batch_size=1),
    loss=dict(count_weight=0.5, bbox_weight=5.0, giou_weight=2.0,
              label_weight=2.0, caption_weight=1.0),
)
# YouCook2 with TSN features (``dvc_yc2_tsn``). The JAX preset table
# writes this key twice and the later entry wins, so this is that entry:
# 3072-d features, 100 queries, counts up to 20 events, no caption head
# named (the plain LSTM, "light"), no clip and no loss section (the
# trainer's clip 0.1 and the criterion's weights apply).
DVC_YC2_TSN = dict(
    model=dict(d_model=512, num_queries=100, n_levels=4,
               num_encoder_layers=2, num_decoder_layers=2,
               max_eseq_length=20, max_caption_len=30, mixer="vim",
               input_dim=3072, num_classes=1),
    opt=dict(learning_rate=5e-5, weight_decay=1e-4, epochs=30),
    loader=dict(batch_size=1),
)


def _without(d: dict, *keys) -> dict:
    return {k: v for k, v in d.items() if k not in keys}


_RECOGNITION_K400 = dict(
    opt=dict(learning_rate=1e-3, weight_decay=0.05, layer_decay=0.75,
             epochs=30, warmup_epochs=5, ema_decay=0.9999),
    aug=dict(mixup=0.8, cutmix=1.0, smoothing=0.1,
             aa="rand-m7-n4-mstd0.5-inc1", reprob=0.25, remode="pixel",
             recount=1),
    loader=dict(batch_size=256),
    test=dict(num_temporal_views=4, num_spatial_views=3),
)
_RECOGNITION_MODEL = dict(embed_dim=192, depth=24, num_frames=16,
                          patch_size=16, img_size=224, num_classes=400,
                          drop_path_rate=0.1)
_TAL_PYRAMID = dict(backbone_arch=[2, 2, 5], embd_dim=512,
                    fpn_type="identity", mixer="dbm", scale_factor=2)

# The JAX package's ``configs/presets.py`` ``PRESETS`` as Python resolves
# it (``"dvc_yc2_tsn"`` is written twice there and the later entry wins):
# the presets the CLI's ``--preset`` names. The constants above are the
# entries they equal; ``TAL_THUMOS`` and ``TAL_ANET`` add the training
# split's size (and ``TAL_ANET`` the trainer's default ``train_cfg``),
# which the presets leave to the data.
PRESETS = {
    "tal_thumos": dict(TAL_THUMOS,
                       dataset=_without(TAL_THUMOS["dataset"],
                                        "train_videos")),
    "tas_gtea": TAS_GTEA,
    "vtg_qvhighlights": VTG_QVHIGHLIGHTS,
    "dvc_anet_c3d": DVC_ANET_C3D,
    "dvc_yc2_tsn": DVC_YC2_TSN,
    "anticipation_ek100": dict(
        model=dict(d_model=1024, mamba_layers=2,
                   long_memory_num_samples=512, work_memory_num_samples=32,
                   anticipation_num_samples=4, num_classes=3807,
                   dropout_cls=0.2),
        opt=dict(learning_rate=7e-5, weight_decay=5e-5, epochs=25),
        loader=dict(batch_size=16),
    ),
    "ego_timemamba_pretrain": dict(
        model=dict(tower="timemamba", embed_dim=768, depth=12, num_heads=12,
                   num_frames=4, project_embed_dim=512, ln_pre=True,
                   attention_style="frozen-in-time", is_tanh_gating=True),
        opt=dict(learning_rate=3e-5, weight_decay=0.01, b2=0.98, epochs=5,
                 warmup_epochs=1),
        loader=dict(batch_size=256, context_length=77),
    ),
    "ego_ek100_mir": dict(
        train=dict(mode="mir"),
        model=dict(vision_tower="timemamba", embed_dim=512, depth=12,
                   num_frames=16, vision_width=768, is_tanh_gating=True),
        opt=dict(learning_rate=1e-5, weight_decay=0.01, epochs=10),
        loader=dict(batch_size=64, context_length=77),
    ),
    "ego_ek100_cls": dict(
        train=dict(mode="cls"),
        model=dict(embed_dim=192, depth=24, num_frames=16, patch_size=16,
                   img_size=224),
        dataset=dict(num_classes=3806),
        opt=dict(learning_rate=1e-4, weight_decay=0.05, epochs=30),
        aug=dict(smoothing=0.1, mixup=0.8, cutmix=1.0),
        loader=dict(batch_size=32),
    ),
    "recognition_k400_vivim_tiny": dict(_RECOGNITION_K400,
                                        model=_RECOGNITION_MODEL),
    "recognition_k400_vivim_small": dict(
        _RECOGNITION_K400, model=dict(_RECOGNITION_MODEL, embed_dim=384)),
    "recognition_k400_vivim_tiny_scan_norm": dict(
        _RECOGNITION_K400, model=dict(_RECOGNITION_MODEL, mixer="scan_norm")),
    "tal_anet": dict(_without(TAL_ANET, "train_cfg"),
                     dataset=_without(TAL_ANET["dataset"], "train_videos")),
    "tal_hacs": dict(
        dataset=dict(num_classes=1, input_dim=3200, feat_stride=8,
                     num_frames=8, max_seq_len=960),
        model=_TAL_PYRAMID,
        opt=dict(learning_rate=1e-3, epochs=15, weight_decay=0.05),
        loader=dict(batch_size=16),
        test_cfg=dict(multiclass_nms=False, ext_score_fusion=True),
    ),
    "tal_fineaction": dict(
        dataset=dict(num_classes=1, input_dim=1408, feat_stride=16,
                     num_frames=16, max_seq_len=192),
        model=_TAL_PYRAMID,
        opt=dict(learning_rate=1e-3, epochs=20, weight_decay=0.05),
        loader=dict(batch_size=16),
        test_cfg=dict(multiclass_nms=False, ext_score_fusion=True),
    ),
    "tas_50salads": TAS_50SALADS,
    "tas_breakfast": TAS_BREAKFAST,
    "vtg_charades": VTG_CHARADES,
    "vtg_tacos": VTG_TACOS,
    "vtg_ego4d": VTG_EGO4D,
    "vtg_tvsum": VTG_TVSUM,
}
