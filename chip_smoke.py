"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py       # one card, a few minutes

Phases, each of which fails the run:
  1. device: require CUDA; print the card's name and power limit.
  2. build: compile every kernel of the port from ``csrc/`` with nvcc, one
     process per source, and print each one's registers, spills and shared
     memory, and a line per tensor-core attention kernel and lane-split
     scan kernel (``RESOURCE_KERNELS``: registers, spill bytes).
  3. kernels: hold each kernel against its plain PyTorch version on the card,
     at the shape the main path gives it and at the other cases of its table
     (``K1_CASES``, ``K2_CASES``, ``K3_CASES`` with K3's checkpoints,
     ``K4_CASES``, ``K5_CASES``, ``K6_CASES``, ``K10_CASES``, ``K9_CASES``,
     ``K11_CASES`` (forward and backward), ``K7_CASES`` with K7's
     checkpoints, ``K8_CASES``, which tests/test_torch_kernels_cuda.py runs
     too; for every kernel (forward and backward) also the kernels the
     profiler saw run (K5's and K6's, then K7's and K8's, each pair in a
     fresh process, ``chip_smoke.py --routes K5 K6``), ``ROUTES``: K1 its
     tile kernel, K3 and K7 their split lane walks, K2, K4, K5 and K6 their
     lane walks, K4's and K8's three (local, combine, main) each with its
     device time, and the scan phases print those kernels' registers and
     spills; attention bf16 on the tensor cores, fp32 on the SIMT kernels, at
     head widths up to 384), and time kernel, plain version and the roofline
     bound (K1, K3, K7 and K8 also their special-function results over the
     units' rate; K3 and K7 also with their checkpoint output; K5, K6, K10,
     K9 and K11 also with their device time from the profiler; K10, K9 and
     K11 also SDPA on the same q, k, v; for K11 SDPA's forward, its forward +
     backward, and its backward alone).
  4. inference: TimeMamba-B (batch 8, 16 frames, 224², bf16, random
     weights from a seed) through ``build_timemamba_b``; launch counts are
     zeroed just before and read just after (K1: 12 per forward). Then a
     torch.profiler window of two forwards.
  5. train step: the same model and batch through ``train_step`` with
     AdamW (lr 1e-4, weight decay 1e-4); 12 K1 and 12 K2 launches per step,
     a finite loss that falls; ms/step, clips/s, MFU, peak memory, and a
     torch.profiler window of two steps.
  6. ViViM-T serving: ``build_vivim_tiny_k400`` (K400, 16 frames, 224²,
     fp32 compute with TF32 matmuls, random weights from a seed) answers
     requests of 8 clips through ``predict``: exactly 48 K3 launches per
     request, no K1 and no plain-version call; ms/request, clips/s, MFU,
     peak memory, one median with TF32 off, a torch.profiler window of two
     requests; then ``evaluate`` over 2 videos x 12 views. K3 writes no
     checkpoints here.
  7. ViViM-T finetune: ``build_vivim_k400_trainer`` at the preset's values
     takes ``RecognitionTrainer.train_step`` on 8 clips (fp32 with TF32
     matmuls; mixup / cutmix, smoothing 0.1, drop-path 0.1, layer decay
     0.75, warmup-cosine AdamW, clip 1.0, EMA): 2 warm-up steps, in which
     the first (rate 0) moves no parameter and every parameter gets a
     finite gradient, and the second moves the parameters and the EMA;
     then 10 timed steps with exactly 48 K3 (writing checkpoints) and 48
     K4 launches each, no plain-version call and a finite loss; ms/step,
     clips/s, MFU, peak memory and a torch.profiler window of two steps.
  8. Mamba-130M serving: ``build_mamba_lm(configs.MAMBA_130M)`` (bf16,
     random weights from a seed) answers requests through ``generate``:
     batch 8, prompt 16, 128 new tokens, greedy; 2 warm-ups, 5 timed
     requests with exactly 24 K5 launches each (the prefill, one per
     layer), no K3 and no plain-version call; ms/request, tok/s, the
     prefill's ms, a decode step's ms and its share of the HBM rate, peak
     memory; a prefill at prompt 1024 launches exactly 24 K3 and no K5;
     a torch.profiler window of one request of 16 new tokens.
  9. anticipation serving: LSTR-Mamba at the EK100 preset's widths
     (``configs.ANTICIPATION_EK100``: 512 + 32 frames of 1024 + 1024
     features, 4 queries, d_model 1024, 2 layers, 3807 classes; random
     weights from a seed, fp32 with TF32 matmuls) answers requests of 16
     windows through ``predict``: exactly 2 K3 per request (no
     checkpoints); the short configuration (long memory 28, 64 tokens)
     exactly 2 K5; no K6 and no plain version; ms/request, peak memory,
     a torch.profiler window of two requests. Then streaming on the short
     model: ``stream_prefill`` over 60 frames (2 K5) and 32
     ``stream_step`` calls (no kernel); ms per step.
 10. anticipation train steps: ``build_anticipation_trainer`` at the
     preset's recipe, ``AnticipationTrainer.train_step`` on 16 windows:
     2 warm-ups (every parameter a finite gradient), then 10 timed steps:
     the preset exactly 2 K3 (writing checkpoints) and 2 K4 per step, the
     short configuration exactly 2 K5 and 2 K6, no plain version, the loss
     finite and falling; ms/step, peak memory, a profiler window of two
     steps.
 11. card against CPU: full width in fp32 (TF32 off), the card through
     the kernels against the CPU through the plain versions: one clip of
     TimeMamba-B's forward at depth 12 and gradients at depth 2, ViViM-T's
     forward at its full depth 24 and its gradients at depth 2; Mamba-130M
     at depth 24, batch 2: prefill logits and every layer's states at
     prompt 16 (K5) and 80 (K3), then 8 decode steps' logits; LSTR-Mamba
     at depth 2: the short configuration at batch 2 (scores,
     ``stream_prefill`` states, every parameter's gradient) and the preset
     at batch 1 (scores).
 12. EK100 MIR serving: ``build_clip_mir`` (CLIP-TimeMamba-B at the
     preset ego_ek100_mir's widths, random weights from a seed; the video
     tower in bf16 with its spatial attention on K10, the text tower in
     fp32 with TF32 matmuls) answers requests of 8 clips (16 × 224²) and 8
     captions of 77 token ids through the CLIP forward: exactly 12 K1 and
     12 K10 per request, no plain version; ms/request, clips/s, peak
     memory, a torch.profiler window; the same requests with
     ``attn_flash=None`` (12 K1, no K10) as the A/B; then
     ``MirFinetuner.evaluate`` over 32 clips x 32 captions against a
     relevancy matrix of seeded verb/noun classes, its six metrics finite
     and equal to those of its embeddings. K10's share of the request's
     device time is read from the profile.
 13. card against CPU, CLIP: CLIP-TimeMamba-B at full width and depth in
     fp32 (TF32 off), one clip and four captions, both embeddings and the
     scale.
 14. flash attention: ``FusedMHA(flash=True)`` at CLIP-TimeMamba-B's text
     width (8 captions x 77 tokens, 512 wide, 8 heads, causal, fp32, TF32
     off) and its spatial width (128 instances x 197 tokens, 768 wide, 12
     heads, bf16), forward and backward: exactly one K11 forward and one
     K11 backward per call, timed against the einsum path (flash=None),
     a torch.profiler window of two calls (K11's forward and backward
     shares of its device time); the card against the CPU in fp32 on up
     to 8 rows. Then
     ``FusedMHA(flash="vmem")`` forward at the spatial width (bf16):
     exactly one K9 per call, timed against the einsum path.
 15. complex scan: ``selective_scan`` with complex A at the scan microbench
     shape (8 x 2048 x 1024, 16 states, fp32, an initial state), forward
     and backward through autograd with cotangents on the output and the
     complex last state: exactly one K7 and one K8 per call (one K7 alone
     without a backward); the card against the plain version on 2 rows.
 16. ActionMamba (temporal action localization): ``build_tal_trainer``
     at the THUMOS-14 preset's widths (``configs.TAL_THUMOS``: batch 2 x
     2304 steps x 3200 features, 20 classes, a DBM pyramid of width 512
     and 6 levels, drop-path 0.1; fp32; synthetic features staged on the
     card once): 2 warm-ups, then 10 timed ``TalTrainer.train_step``
     calls with exactly 14 K3 (writing checkpoints) and 14 K4 a step and
     no other scan kernel; ms/step, peak memory and a profile window.
     ``predict_video`` over 4 synthetic videos (14 K3 a video, no
     checkpoints), ms/video, and ``evaluate``'s mAP (no target). The
     ActivityNet preset (``configs.TAL_ANET``: batch 16 x 192 steps)
     with exactly 8 K3, 8 K4, 3 K1 and 3 K2 a step. Then full-width fp32
     ActionMamba (THUMOS), card against CPU: every level's logits and
     offsets and one step's gradients. Their scan launches add to the
     kernels line's counts.
 17. EK100 MIR fine-tuning: ``build_clip_mir`` (bf16 video tower on K10,
     fp32 text tower with TF32 matmuls, the preset's AdamW b2 0.98,
     warmup-cosine, clip 1.0) takes ``MirFinetuner.train_step`` on 8
     clips (16 × 224²) and 8 captions: 2 warm-ups (every parameter a
     finite gradient), then timed steps with exactly 12 K1, 12 K10 and 12
     K2 each and no plain version; ms/step, clips/s, peak memory, a
     profile window.
 18. CLIP pretraining: ``build_clip_pretrainer`` (the Ego4D preset, 4
     frames) on 32 clips and 32 captions a step: the same launches; then
     ``encode``.
 19. EK100 classification: ``build_ek100_cls`` (ViViM-T, 3806 actions,
     mixup / cutmix, fp32 with TF32 matmuls) on 8 clips a step: exactly
     48 K3 with checkpoints and 48 K4; then ``evaluate`` over 16 clips x
     2 crops with verb and noun marginals (48 K3 a batch of 8).
 20. int8 LM serving: ``quantize_lm_for_decode`` of Mamba-130M, then
     ``generate`` of 8 prompts of 16 + 128 new tokens: exactly 24 K5 a
     request; the bf16 model as the A/B (int8, bf16, int8 again); the
     weights' bytes and each model's device ms a generated token from a
     profile of a request of 16 new tokens.
 21. LM scoring: ``perplexity`` of 8 x 1024 tokens (24 K3) and
     ``MambaHarnessLM.loglikelihood`` of 16 requests of more than 64
     characters (24 K3 a batch of 8).
 22. card against CPU: one MIR step at full width and depth 2 + 2 in fp32
     (TF32 off), the loss and every gradient; the int8 Mamba-130M's
     logits at prompts 16 (K5) and 80 (K3), forward, prefill and 4 decode
     steps. The new phases' launches add to the kernels line's counts.
 23. TAS on GTEA: ``build_tas_trainer(configs.TAS_GTEA)`` at the preset's
     full widths (10 masked ViM encoder layers at d_model 64, 3 decoders
     of 10 layers, 2048-d features, 11 classes, dropout and drop-path on
     the trainer's generator; fp32) on one synthetic video of 1500
     features: 2 warm-ups (every parameter a finite gradient), then 5
     timed ``TasTrainer.train_step`` calls with exactly 20 K3 (writing
     checkpoints) and 20 K4 each and no plain version; ms/step, peak
     memory, a profile window; then ``evaluate`` over 4 synthetic videos
     (20 K3 a video, no checkpoints): ms a video, acc, edit, F1@{10,25,50}.
 24. TAS on 50Salads (``configs.TAS_50SALADS``, 19 classes): the same on
     a video of 6000 features, ``evaluate`` over 2.
 25. upstream checkpoints: an upstream-layout CLIP-TimeMamba-B state dict
     at the ego_ek100_mir widths saved beside an ``argparse.Namespace``,
     read by ``load_state_dict``, converted by ``clip_from_state_dict`` and
     loaded strictly into ``build_clip_mir``'s model: one MIR request,
     exactly 12 K1 and 12 K10; an upstream ViViM-T state dict whose
     8-frame temporal embedding ``inflate_temporal_embed`` takes to 16,
     through ``vivim_from_state_dict``: one recognition request, 48 K3.
 26. card against CPU: one TAS step with dropout off at full width, depth
     3 and one decoder, 300 steps, fp32 (TF32 off): the loss and every
     gradient. The new phases' launches add to the kernels line's counts.
 27. UniVTG-Mamba on QVHighlights: ``build_vtg_trainer(configs.
     VTG_QVHIGHLIGHTS)`` at the preset's full widths (512-d text and
     2816-d video into 1024, 6 DBM layers, input dropout 0.5, drop-path
     0.1, AdamW with clip 0.1; fp32, TF32 off) on a batch of 32 synthetic
     samples
     padded to 32 + 75 steps: 2 warm-ups, then 5 timed ``train_step``
     calls with exactly 12 K3 (writing checkpoints) and 12 K4 each and no
     plain version; ms/step, peak memory, a profile window; then
     ``predict`` of 8 samples (12 K3, no checkpoints) timed and
     ``evaluate`` over 32 (its mAP, mIoU, R1, HL metrics; no target).
 28. TVSum highlight detection: ``build_hl_trainer(configs.VTG_TVSUM)``,
     4 videos x (1 + 512) steps a step: the same launches; then
     ``predict_scores`` of one video (12 K3) timed and the top-5 mAP over
     4 synthetic videos and 20 annotators.
 29. VLP and QFVS at the QVHighlights model widths: ``VlpPretrainer.
     zero_shot_class_scores`` of 8 samples x 20 class names (12 K3 a
     call), then ``QfvsTrainer`` steps on 4 items of 3 x 8 frames, three
     forwards of at most 64 steps a step: exactly 18 K1 and 18 K2; its
     ``evaluate`` (18 K1).
 30. card against CPU: UniVTG-Mamba at the QVHighlights widths, depth 2,
     8 x 107 steps, fp32 (TF32 off): every forward output, then one step
     with dropout off: each loss term and every gradient. The launches
     of 27-29 add to the kernels line's counts.
 31. PDVC-Mamba dense captioning on ActivityNet Captions:
     ``build_captioning_trainer(configs.DVC_ANET_C3D)`` at the preset's
     full widths (500-d features into 512, 2 ViM layers over the 480
     pyramid tokens, 2 deformable decoder layers, 10 queries, the LSTM-DSA
     caption head, captions of 30 tokens; fp32, TF32 off) on 16 synthetic
     videos read by ``load_activitynet_captions`` (the vocabulary built
     from their sentences) and ``collate_captioning``, batch 1: 2
     warm-ups, then 10 timed ``train_step`` calls with exactly 4 K3
     (writing checkpoints) and 4 K4 each and no plain version; ms/step,
     peak memory, a profile window, the Hungarian assignment's host ms;
     ``predict`` of one video (4 K3) timed, then every video predicted and
     ``evaluate_dvc``, ``soda_c`` and ``evaluate_para`` (no target).
 32. YouCook2 (``configs.DVC_YC2_TSN``: 3072-d features, 100 queries, the
     plain LSTM head, counts up to 20) on 4 synthetic videos: the same.
 33. the JAX CLI's synthetic captioning task through ``CaptioningTrainer``:
     200 steps of 2 K3 and 2 K4 at 2 x 96 x 64; the loss falls and the
     last loss_bbox is under 0.2; ``predict`` and ``evaluate_dvc``,
     CIDEr and METEOR printed as ``cap_cider`` and ``cap_meteor``.
 34. card against CPU: PDVC-Mamba at the ActivityNet widths and depth, one
     video of 256 features, fp32 (TF32 off), dropout off: every forward
     output, the caption logits and the greedy tokens, then under the
     CPU's match each loss term and every gradient. The launches of 31-33
     add to the kernels line's counts.
 35. the task CLI's synthetic trajectories (``cli-synthetic``):
     ``cli.main`` in this process for the seven tasks and the egocentric
     MIR and classification modes (``CLI_RUNS``: bench.py's epochs where
     it runs the task, else the CLI's 5); each run launches at least one
     of K1-K6 and no plain version; its launches, wall seconds and the
     numbers bench.py reads (``vtg_r1_05``, ``vtg_map_avg``,
     ``mir_avg_map``, ``tas_f1_50``, ``cap_cider``, ``cap_meteor``,
     ``ant_mean_ap``, ``rec_top1``; printed, not gated).
 36. THUMOS-14 through the CLI (``cli-tal-thumos``): a THUMOS-layout
     dataset (4 training and 2 validation videos of 3264 steps x 3200
     features from seed 0) under a temporary directory; ``tal --preset
     tal_thumos`` for one epoch in this process (14 K3 with checkpoints +
     14 K4 a step, 14 K3 a validation video); ``python -m
     video_mamba_suite_torch.cli ... --epochs 3 --ckpt D`` in a child sent
     SIGTERM once it prints ``epoch 0:``, which exits 0 with its last
     printed epoch on disk; the rerun resumes after it and prints the mAP
     line.
 37. card against CPU, the CLI's checkpoint (``card-vs-cpu-ckpt``): phase
     36's newest checkpoint restored into a ``TalTrainer`` on the card and
     one on the CPU, every restored tensor equal to the file's bit for
     bit, both on one validation video (fp32, TF32 off, EMA weights)
     within 1e-5 of each output's scale (its largest magnitude over the
     pyramid's levels). The launches of 35-36 add to the kernels
     line's counts. (Phase 16's THUMOS eval also times its parts apart:
     forward, decode, soft-NMS and voting by numpy and by the native op.)
 38. recognition on video files (``cli-recognition-video``): ``recognition
     --preset recognition_k400_vivim_tiny`` on a K400-layout csv of 16
     ``.npy`` videos of 48 frames at 224² (uint8 from seed 0; the card's
     machine decodes no other format), batch 8 (the preset's 256 cut to
     8), one epoch: 2 steps of exactly 48 K3 with checkpoints and 48 K4,
     no plain version, the preset's RandAugment and erasing on the host;
     per step the decode, augment and step ms, and the step's device
     busy share from a profile window; then the same two steps' work fed
     through ``PrefetchLoader`` (2 workers, pinned copies): ms a step.
 39. the egocentric modes on video files (``cli-ego-video``): 16 ``.npy``
     clips of 32 frames at 224² with captions in a metadata json and
     labels in a csv; ``egocentric --preset ego_ek100_mir`` (batch 8 of
     64: 12 K1 + 12 K10 + 12 K2 a step, then the retrieval evaluation, 12
     K1 + 12 K10 a batch, and its avg_map), ``--preset
     ego_timemamba_pretrain`` (batch 8 of 256) and ``--preset
     ego_ek100_cls`` (batch 8 of 32: 48 K3 + 48 K4 a step, evaluate 48
     K3 a batch), one epoch each: per step the decode and step ms, and
     the busy share.
 40. VTG on a raw video (``vtg-run-on-video``): a 60 s ``.npy`` video
     (1800 frames of 128 x 170) through ``VtgFeatureExtractor`` at CLIP
     ViT-B/32's widths (random weights from a seed) and ``ground_video``
     with the QVHighlights preset's model at 514-d video and 512-d text:
     30 clips, exactly 2 K3 a DBM layer; ms for the features and for the
     grounding.
 41. card against CPU, the device stages (``card-vs-cpu-video``):
     ``preprocess_clip`` (train mode at fixed offsets, 16 x 256 x 340 to
     224²) within 1e-4; one ``ground_video`` at phase 40's widths, depth
     2, fp32 (TF32 off): spans and saliency within 1e-4 of their scale,
     the windows ranked alike. The launches of 38-40 add to the kernels
     line's counts.
Prints a ``{"kernels": [...]}`` line (K1-K11) and, last, ``{"ok": true,
...}``. ``chip_smoke.py --phases NAME ...`` builds the kernels and runs
the named phases of ``PHASES`` alone (17-41; 37 after 36), printing no
result line.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import importlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
import types

# H100 SXM peaks (NVIDIA data sheet, dense, at the full 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12          # outside the tensor cores
BF16_TC_FLOP_PER_S = 989e12
TF32_TC_FLOP_PER_S = 495e12
# special function unit results (exp2, log2, reciprocal): 16 a clock an SM,
# 132 SMs, at the 1980 MHz boost clock
SFU_PER_S = 16 * 132 * 1.98e9

BATCH = 8                        # clips per main-path request
FORWARDS = 10                    # timed main-path batches (requests)
TRAIN_STEPS = 10                 # timed train steps
K1_SOURCE = "video_mamba_suite_torch/csrc/short_bidir_fwd.cu"
K1_REPLACES = "video_mamba_suite_tpu/ops/selective_scan_pallas.py:1244"
K2_SOURCE = "video_mamba_suite_torch/csrc/short_bidir_bwd.cu"
K2_REPLACES = "video_mamba_suite_tpu/ops/selective_scan_pallas.py:1292"
# K1 against its plain version: (label, (batch, seqlen, dim, dstate), I/O
# dtype, with D and z, with A, D and bias one tensor in both directions).
# tests/test_torch_kernels_cuda.py runs the same cases.
# The last four reach the edges of K1's 128-channel tile: 64 fp32 steps
# (the largest shared tile), one step, 200 bf16 channels (16-byte copies;
# the second tile holds 72), and 8 states (16-byte B/C rows of 32 bytes).
K1_CASES = [
    ("main", (1568, 16, 768, 16), "bfloat16", True, False),  # TimeMamba-B
    ("ragged", (37, 11, 200, 13), "float32", True, False),  # no tile fits
    ("longest-no-Dz", (5, 64, 33, 4), "float32", False, False),
    ("l64-fp32", (7, 64, 256, 16), "float32", True, False),
    ("one-step", (9, 1, 96, 16), "bfloat16", True, False),
    ("ragged-vec-bf16", (6, 16, 200, 16), "bfloat16", True, False),
    ("n8-vec", (5, 16, 128, 8), "float32", True, False),  # 16-byte B/C rows
    # ActionMamba's ActivityNet level of 12 steps (no multiple of 8), the
    # DBM mixer's shared parameters in both directions
    ("tal-anet-l12", (16, 12, 512, 16), "float32", True, True),
]
# fp32 as the JAX kernel tests; bf16 output one to two bf16 ulps apart
# (both round an fp32 result; sums differ in order)
K1_TOL = {"float32": (2e-4, 2e-4), "bfloat16": (2e-2, 2e-2)}
# K2 against its plain version, at K1's cases and the edges of its lane
# groups: one step and 130 channels (a 128-channel block and 2 channels of
# the next), and 63 steps of 64 channels with 7 states (a lane group whose
# last lane holds no state, element copies). Each gradient within
# atol · (its largest magnitude) + rtol · |value|. fp32 as K1; bf16 outputs
# (du, ddt, dz, dB, dC) one to two bf16 ulps apart, the fp32 sums (dA, dD,
# dbias) in another order.
K2_CASES = K1_CASES + [
    ("one-step-ragged", (9, 1, 130, 16), "float32", True, False),
    ("l63-n7", (3, 63, 64, 7), "bfloat16", True, False),
]
K2_TOL = {"float32": (2e-4, 2e-4), "bfloat16": (2e-2, 2e-2)}
K3_SOURCE = "video_mamba_suite_torch/csrc/chunked_scan_fwd.cu"
K3_REPLACES = ("video_mamba_suite_tpu/ops/selective_scan_pallas.py:113 "
               "(_fwd_kernel) and :2244 (_fwd_kernel_hs)")
# K3 against its plain version: (label, (batch, seqlen, dim, dstate), I/O
# dtype, options: reverse, h0 (an initial state), groups (grouped B/C),
# no_dz (no D, no z)). tests/test_torch_kernels_cuda.py runs the same
# cases. The first is ViViM-T's main path; batch 1 is the shape the TPU
# package gives its batch <= 4 body; (8, 2048, 1024, 16) bf16 is the scan
# microbench of bench.py:139.
K3_CASES = [
    ("vivim", (8, 3152, 384, 16), "float32", {}),
    ("vivim-reverse", (8, 3152, 384, 16), "float32", {"reverse": True}),
    ("vivim-b1", (1, 3152, 384, 16), "float32", {}),
    ("vivim-b1-reverse", (1, 3152, 384, 16), "float32", {"reverse": True}),
    ("scan-bench", (8, 2048, 1024, 16), "bfloat16", {}),
    ("ragged-h0-reverse", (3, 70, 200, 13), "float32",
     {"reverse": True, "h0": True}),
    ("grouped-h0", (5, 100, 64, 16), "float32",
     {"groups": 2, "h0": True, "no_dz": True}),
    # the edges of the split walk: 45 channels (no multiple of 8 or of the
    # 32-channel tile: element copies); 1001 steps (no multiple of the
    # 16-step unit) split into 8 segments of 128 steps, the last 105, with
    # checkpoints inside each; batch 1 anti-causal from an initial state in
    # bf16 (8 segments); one step
    ("d45-bf16", (2, 300, 45, 16), "bfloat16", {}),
    ("l1001-split-h0", (3, 1001, 96, 16), "float32", {"h0": True}),
    ("vivim-b1-reverse-h0-bf16", (1, 3152, 384, 16), "bfloat16",
     {"reverse": True, "h0": True}),
    ("one-step-h0", (4, 1, 64, 16), "float32", {"h0": True}),
    # 16-byte copies of 8-state B/C rows in groups of 64 channels
    ("n8-vec-grouped-reverse", (2, 200, 128, 8), "float32",
     {"groups": 2, "reverse": True}),
    # ActionMamba's THUMOS-14 stem: the DBM mixer's anti-causal direction
    ("tal-thumos-reverse", (2, 2304, 512, 16), "float32", {"reverse": True}),
    # ASFormer-Mamba's encoder (d_inner 128, one video): a 50Salads video
    # of 6000 features and a GTEA one of 1499 (no multiple of 16) backwards
    ("tas-50salads", (1, 6000, 128, 16), "float32", {}),
    ("tas-gtea-reverse", (1, 1499, 128, 16), "float32", {"reverse": True}),
    # UniVTG-Mamba's DBM layers (d_inner 1024): a QVHighlights batch of 32
    # x (32 query + 75 clip steps) in both directions, and a TVSum batch
    # of 4 x (1 + 512) anti-causally
    ("vtg-qvhl", (32, 107, 1024, 16), "float32", {}),
    ("vtg-qvhl-reverse", (32, 107, 1024, 16), "float32", {"reverse": True}),
    ("vtg-tvsum-reverse", (4, 513, 1024, 16), "float32", {"reverse": True}),
    # PDVC-Mamba's ViM encoder at the ActivityNet preset (d_inner 1024):
    # one video's 256 + 128 + 64 + 32 = 480 pyramid tokens, both directions
    ("dvc-anet", (1, 480, 1024, 16), "float32", {}),
    ("dvc-anet-reverse", (1, 480, 1024, 16), "float32", {"reverse": True}),
]
# each output within atol · (its largest magnitude) + rtol · |value|: a long
# scan's outputs reach tens, and a value near 0 carries the rounding of
# its neighbours. fp32 as K1; bf16 outputs one to two bf16 ulps apart
# (both round an fp32 result; the kernel chains segments where the plain
# version walks every step). The last state is fp32 in both cases.
K3_TOL = {"float32": (2e-4, 2e-4), "bfloat16": (2e-2, 2e-2)}
K4_SOURCE = "video_mamba_suite_torch/csrc/chunked_scan_bwd.cu"
K4_REPLACES = ("video_mamba_suite_tpu/ops/selective_scan_pallas.py:187 "
               "(_bwd_kernel) and :2292 (_bwd_kernel_hs)")
# K4 against its plain version: K3's options, each case with a cotangent
# of the last state as well as of the output. The first two are ViViM-T's
# main path (one per direction); batch 1 is the TPU package's batch <= 4
# body; ragged: a length that is no multiple of the checkpoint interval,
# 200 channels (no multiple of a 32-channel warp) and 13 states; grouped:
# groups of 48 channels, so the second warp of a group is half idle; then
# a length that is no multiple of 16 with 100 channels (the last 32-channel
# unit holds 4) and 5 states (element copies), and bf16 with 4 groups of
# 96 channels. tests/test_torch_kernels_cuda.py runs the same cases.
K4_CASES = [
    ("vivim", (8, 3152, 384, 16), "float32", {}),
    ("vivim-reverse", (8, 3152, 384, 16), "float32", {"reverse": True}),
    ("vivim-b1", (1, 3152, 384, 16), "float32", {}),
    ("vivim-b1-reverse", (1, 3152, 384, 16), "float32", {"reverse": True}),
    ("scan-bench", (8, 2048, 1024, 16), "bfloat16", {}),
    ("ragged-h0-reverse", (3, 70, 200, 13), "float32",
     {"reverse": True, "h0": True}),
    ("grouped-h0-no-Dz", (5, 100, 96, 16), "float32",
     {"groups": 2, "h0": True, "no_dz": True}),
    ("l37-d100-n5-reverse-h0", (2, 37, 100, 5), "float32",
     {"reverse": True, "h0": True}),
    ("grouped4-bf16", (4, 64, 384, 16), "bfloat16", {"groups": 4}),
    ("tal-thumos-reverse", (2, 2304, 512, 16), "float32", {"reverse": True}),
    ("tas-50salads", (1, 6000, 128, 16), "float32", {}),
    ("tas-gtea-reverse", (1, 1499, 128, 16), "float32", {"reverse": True}),
    ("vtg-qvhl", (32, 107, 1024, 16), "float32", {}),
    ("vtg-qvhl-reverse", (32, 107, 1024, 16), "float32", {"reverse": True}),
    ("vtg-tvsum-reverse", (4, 513, 1024, 16), "float32", {"reverse": True}),
    ("dvc-anet", (1, 480, 1024, 16), "float32", {}),
    ("dvc-anet-reverse", (1, 480, 1024, 16), "float32", {"reverse": True}),
]
# each gradient within atol · (its largest magnitude) + rtol · |value|, as
# K2: fp32 sums (dA over 3152 steps and the rows, dB and dC over the
# channels) in another order; bf16 outputs one to two bf16 ulps apart.
K4_TOL = {"float32": (2e-4, 2e-4), "bfloat16": (2e-2, 2e-2)}
VIVIM_LAUNCHES = 48              # K3 launches per ViViM-T forward
VIVIM_REQUESTS = 10              # timed serving requests of BATCH clips
# full-width fp32 forward, card against CPU, relative to the output scale:
# read 9.2e-7 on an H100 80GB HBM3 (PERF.md), held at about ten times that
CARD_CPU_REL_TOL = 1e-5
# full-width fp32 gradients at depth 2, card against CPU, each parameter's
# largest difference over its largest CPU gradient: read 3.7e-6 on an H100
# 80GB HBM3 (PERF.md), held at about ten times that
CARD_CPU_GRAD_REL_TOL = 4e-5
GRAD_DEPTH = 2
# ViViM-T's full-depth fp32 forward (logits), card against CPU, relative to
# the output scale: read 1.1e-6 on an H100 80GB HBM3 (PERF.md), held at
# about ten times that
CARD_CPU_VIVIM_REL_TOL = 1.1e-5
FINETUNE_STEPS = 10              # timed ViViM-T finetune steps
K5_SOURCE = "video_mamba_suite_torch/csrc/short_scan_fwd.cu"
K5_REPLACES = "video_mamba_suite_tpu/ops/selective_scan_pallas.py:927"
# K5 against its plain version: K3's options without h0 (K5 takes none).
# The first is the Mamba-130M prefill at a 16-token prompt (one launch per
# layer; ``check_k5`` returns its numbers as the main path's), the second
# the short anticipation call's scan (16 windows of 64 tokens, d_inner
# 2048, fp32; one launch per layer); adapter: the TimeMamba-B video-adapter
# shape the TPU kernel was written for; ragged: 13 steps, 200 channels and
# 13 states; then the limit of 64 steps, one step, reverse, grouped B/C
# (two groups of 48 channels, so a 32-channel tile is half idle), no D and
# no z, batch 1. tests/test_torch_kernels_cuda.py runs the same cases.
K5_CASES = [
    ("lm", (8, 16, 1536, 16), "bfloat16", {}),
    ("anticipation", (16, 64, 2048, 16), "float32", {}),
    ("lm-fp32", (8, 16, 1536, 16), "float32", {}),
    ("adapter", (1568, 16, 768, 16), "bfloat16", {}),
    ("ragged", (3, 13, 200, 13), "float32", {}),
    ("longest", (4, 64, 256, 16), "float32", {}),
    ("one-step", (4, 1, 256, 16), "float32", {}),
    ("reverse", (4, 40, 384, 16), "float32", {"reverse": True}),
    ("grouped", (4, 32, 96, 16), "float32", {"groups": 2}),
    ("no-Dz", (4, 24, 256, 16), "bfloat16", {"no_dz": True}),
    ("batch1", (1, 16, 1536, 16), "bfloat16", {}),
]
# each output within atol · (its largest magnitude) + rtol · |value|: fp32
# as the JAX kernel tests hold K5 (both walk the same <= 64 steps in fp32);
# bf16 outputs one to two bf16 ulps apart (both round an fp32 result). The
# fp32 last state is held at the fp32 tolerance in both cases: the inputs
# are the same bf16 values and both compute in fp32.
K5_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (2e-2, 2e-2)}
LM_BATCH, LM_PROMPT, LM_NEW = 8, 16, 128   # bench.py's decode point
LM_LONG_PROMPT = 1024            # a prompt that takes K3
LM_REQUESTS = 5                  # timed generate requests
# Mamba-130M at full width and depth, fp32, TF32 off, card against CPU,
# each tensor's largest difference over its largest CPU magnitude (prefill
# logits, every layer's states, decode logits): read at most 6.2e-6 on an
# H100 80GB HBM3 (PERF.md), held at about ten times that
CARD_CPU_LM_REL_TOL = 6e-5
CARD_CPU_LM_STEPS = 8            # decode steps fed the same tokens
# ViViM-T fp32 gradients at depth 2, batch 1 (K3 and K4 in the <= 4 form),
# card against CPU, each parameter's largest difference over its largest
# CPU gradient: read 3.5e-6 on an H100 80GB HBM3 (PERF.md), held at about
# ten times that
CARD_CPU_VIVIM_GRAD_REL_TOL = 4e-5


K6_SOURCE = "video_mamba_suite_torch/csrc/short_scan_bwd.cu"
K6_REPLACES = "video_mamba_suite_tpu/ops/selective_scan_pallas.py:958"
# K6 against its plain version: K5's options. The first two are the
# short-memory anticipation train step's scan (28 + 32 + 4 = 64 tokens,
# d_inner 2048, batch 16; one launch per layer per step) in fp32 and bf16;
# ragged: 13 steps, 200 channels and 13 states; then one step, reverse,
# grouped B/C (two groups of 48 channels), no D and no z, TimeMamba-B's
# adapter shape, at which K2 and K5 were timed, and one window of the
# anticipation shape (64 blocks: a grid far below the card).
# tests/test_torch_kernels_cuda.py runs the same cases.
K6_CASES = [
    ("anticipation", (16, 64, 2048, 16), "float32", {}),
    ("anticipation-bf16", (16, 64, 2048, 16), "bfloat16", {}),
    ("ragged", (3, 13, 200, 13), "float32", {}),
    ("one-step", (4, 1, 256, 16), "float32", {}),
    ("reverse", (4, 40, 384, 16), "float32", {"reverse": True}),
    ("grouped", (4, 32, 96, 16), "float32", {"groups": 2}),
    ("no-Dz", (4, 24, 256, 16), "bfloat16", {"no_dz": True}),
    ("adapter", (1568, 16, 768, 16), "bfloat16", {}),
    ("batch1", (1, 64, 2048, 16), "float32", {}),
]
# each gradient within atol · (its largest magnitude) + rtol · |value|:
# fp32 as K5 (sums of dA over the rows and steps, and of dB and dC over up
# to 2048 channels, in another order read at most 3.5e-7 of the scale on
# an H100 80GB HBM3, PERF.md); bf16 outputs one to two bf16 ulps apart.
K6_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (2e-2, 2e-2)}
ANT_REQUESTS = 10                # timed anticipation serving requests
ANT_STEPS = 10                   # timed anticipation train steps
ANT_HISTORY = 60                 # frames of the streaming prefill
ANT_STREAM_STEPS = 32            # streaming steps after it
ANT_LAYERS = 2                   # causal blocks of the preset
# LSTR-Mamba at full width, depth 2, fp32, TF32 off, card against CPU, each
# tensor's largest difference over its largest CPU magnitude: scores and
# streaming states read at most 5.1e-6 (the preset's 548-token scores),
# every parameter's gradient 2.8e-6, on an H100 80GB HBM3 (PERF.md); held
# at about ten times that
CARD_CPU_ANT_REL_TOL = 5e-5
CARD_CPU_ANT_GRAD_REL_TOL = 3e-5


K10_SOURCE = "video_mamba_suite_torch/csrc/row_mha_fwd.cu"
K10_REPLACES = "video_mamba_suite_tpu/ops/vision_attention.py:175"
K9_SOURCE = K10_SOURCE
K9_REPLACES = "video_mamba_suite_tpu/ops/vision_attention.py:55"
# K10 against its plain version: (label, (B, T, H, N, dh), I/O dtype,
# layout). "projection": q, k and v read through strides from a
# (B, N, T, 3·H·dh) projection output, the output written as (B, N, T,
# H·dh), as FusedMHA(flash="row") gives them; "packed": a contiguous
# head-major (B, T, 3H, N, dh), as row_mha_qkv's callers may. The first is
# the EK100 MIR request's spatial attention (8 clips of 16 frames, 12
# heads, 197 tokens; one launch per video-tower block); text: the text
# tower's widths (8 heads, 77 tokens); then the whole-row limit of 512
# tokens (at dh 128, the most shared memory), and the JAX tests' ragged
# shapes (37 tokens of 16, and 197 tokens of 8). tests/test_torch_kernels_
# cuda.py runs the same cases.
K10_CASES = [
    ("mir", (8, 16, 12, 197, 64), "bfloat16", "projection"),
    ("mir-fp32", (8, 16, 12, 197, 64), "float32", "projection"),
    ("mir-packed", (8, 16, 12, 197, 64), "bfloat16", "packed"),
    ("text", (8, 1, 8, 77, 64), "float32", "packed"),
    ("n512", (2, 2, 4, 512, 64), "bfloat16", "packed"),
    ("n512-dh128", (1, 2, 2, 512, 128), "float32", "packed"),
    ("ragged", (2, 3, 4, 37, 16), "float32", "packed"),
    ("ragged-bf16", (2, 3, 4, 37, 16), "bfloat16", "projection"),
    ("dh8", (1, 2, 2, 197, 8), "float32", "packed"),
    ("dh8-bf16", (1, 2, 2, 197, 8), "bfloat16", "packed"),
    ("dh256", (2, 2, 4, 197, 256), "bfloat16", "projection"),
    ("dh200", (1, 2, 2, 100, 200), "bfloat16", "packed"),
    ("dh200-fp32", (1, 2, 2, 100, 200), "float32", "packed"),
]
# K9 against its plain version: (label, (I, H, N, dh), I/O dtype, layout):
# "contiguous" q, k, v of (I, H, N, dh); "projection": (I, H, N, dh) views
# of a (I, N, 3·H·dh) projection output, as FusedMHA(flash="vmem") gives
# them. vision: the TimeMamba-B spatial shape flattened to instances (B·T
# = 128); text: the text tower's (8 captions, 8 heads, 77 tokens); then
# the JAX tests' shapes and 512 tokens; then the edges of the bf16
# tensor-core kernel: one and two 16-row warps (N 16, 17), a whole and a
# started fifth 64-key tile (N 256, 257), the most rows and columns (N 512
# at dh 128), and head widths whose strides allow only 8-, 4- or 2-byte
# copies (dh 20 in the projection layout, 18, 17); then head widths above
# 128 (two 128-column slices, the second full at 256 and ragged at 200).
# K10's cases end the same way.
K9_CASES = [
    ("vision", (128, 12, 197, 64), "bfloat16", "contiguous"),
    ("text", (8, 8, 77, 64), "float32", "projection"),
    ("ragged", (4, 3, 37, 16), "float32", "contiguous"),
    ("ragged-bf16", (4, 3, 37, 16), "bfloat16", "projection"),
    ("dh8", (2, 2, 197, 8), "float32", "contiguous"),
    ("dh8-bf16", (2, 2, 197, 8), "bfloat16", "contiguous"),
    ("n512", (4, 4, 512, 64), "bfloat16", "contiguous"),
    ("n16", (4, 4, 16, 64), "bfloat16", "contiguous"),
    ("n17", (4, 4, 17, 32), "bfloat16", "projection"),
    ("n256", (4, 4, 256, 64), "bfloat16", "contiguous"),
    ("n257", (4, 4, 257, 64), "bfloat16", "projection"),
    ("n512-dh128", (2, 2, 512, 128), "bfloat16", "projection"),
    ("dh20-unaligned", (4, 3, 50, 20), "bfloat16", "projection"),
    ("dh18", (2, 3, 40, 18), "bfloat16", "contiguous"),
    ("dh17", (2, 3, 45, 17), "bfloat16", "projection"),
    ("dh256", (8, 4, 197, 256), "bfloat16", "contiguous"),
    ("dh200", (2, 3, 60, 200), "bfloat16", "projection"),
    ("dh200-fp32", (2, 3, 60, 200), "float32", "contiguous"),
]
# largest |kernel - plain| over the output (values below 2): fp32 read at
# most 3.6e-7 on an H100 80GB HBM3 (sums in another order; PERF.md), held
# at about ten times that; bf16 one to two bf16 ulps apart (read 3.9e-3:
# the weights or the output rounded on either side of a tie), held at the
# JAX tests' 2e-2
ATTN_TOL = {"float32": 4e-6, "bfloat16": 2e-2}
K11_SOURCE = "video_mamba_suite_torch/csrc/flash_mha.cu"
K11_REPLACES = ("video_mamba_suite_tpu/models/common.py:320 (_flash_mha: "
                "jax/experimental/pallas/ops/tpu/flash_attention.py:331, "
                "_flash_attention_kernel)")
K11_BWD_REPLACES = ("video_mamba_suite_tpu/models/common.py:320 (_flash_mha:"
                    " jax/experimental/pallas/ops/tpu/flash_attention.py:796,"
                    " _flash_attention_dkv_kernel, and :1146, "
                    "_flash_attention_dq_kernel)")
# K11 forward and backward against their plain versions: (label, (B, L, H,
# dh), causal, I/O dtype, layout). "projection": q, k and v are views of one
# (B, L, 3·H·dh) projection output, as FusedMHA(flash=True) gives them;
# "contiguous": three tensors; "stride4": views of (B, L, H, dh + 4)
# buffers, every stride a multiple of 4 bf16 but not all of 8 (no 16-byte
# copies). vision: CLIP-TimeMamba-B's spatial attention
# flattened to 128 = 8 clips x 16 frames (K9's shape, so K11, K9 and SDPA
# time the same work); text: its text tower (8 captions of 77 tokens, 8
# heads, causal); long: 2 x 2048 tokens, causal, the long sequences the JAX
# package opts into flash for; then dh 128, a ragged bf16 length, and one
# token, and a length that is not a multiple of the 64-key tile without
# the causal mask in fp32 (the masking of keys at or past L alone); then
# the edges of the bf16 tensor-core kernels' 64-row blocks and 64-key
# tiles (L 63, 64, 65, causal and not; dh 128 causal at L 300, whose
# backward holds the most registers) and 8-byte copies (stride4); then the
# head widths of jax's flash_attention other than 64 and 128: 96 (zero-
# filled to 128), 36 (no multiple of 8: a padded copy), 256 and 384 (two
# and three 128-column slices), both types, causal and not.
# tests/test_torch_kernels_cuda.py runs the same cases.
K11_CASES = [
    ("vision", (128, 197, 12, 64), False, "bfloat16", "projection"),
    ("text", (8, 77, 8, 64), True, "float32", "projection"),
    ("long", (2, 2048, 8, 64), True, "bfloat16", "contiguous"),
    ("dh128", (2, 130, 4, 128), True, "float32", "contiguous"),
    ("dh128-bf16", (2, 300, 2, 128), False, "bfloat16", "projection"),
    ("one-token", (3, 1, 2, 64), True, "float32", "contiguous"),
    ("ragged-full", (2, 100, 3, 64), False, "float32", "contiguous"),
    ("l63", (2, 63, 2, 64), True, "bfloat16", "contiguous"),
    ("l63-full", (2, 63, 2, 64), False, "bfloat16", "projection"),
    ("l64", (2, 64, 2, 64), True, "bfloat16", "projection"),
    ("l64-full", (2, 64, 2, 64), False, "bfloat16", "contiguous"),
    ("l65", (2, 65, 2, 128), True, "bfloat16", "contiguous"),
    ("l65-full", (2, 65, 3, 64), False, "bfloat16", "projection"),
    ("stride4", (2, 100, 3, 64), True, "bfloat16", "stride4"),
    ("dh128-bf16-causal", (2, 300, 2, 128), True, "bfloat16", "contiguous"),
    ("dh96", (2, 100, 3, 96), True, "bfloat16", "projection"),
    ("dh96-fp32", (2, 100, 3, 96), False, "float32", "contiguous"),
    ("dh36", (2, 50, 2, 36), True, "bfloat16", "contiguous"),
    ("dh256", (2, 150, 2, 256), False, "bfloat16", "projection"),
    ("dh256-fp32-causal", (2, 150, 2, 256), True, "float32", "contiguous"),
    ("dh384-causal", (2, 130, 2, 384), True, "bfloat16", "contiguous"),
    ("dh384-fp32", (1, 70, 2, 384), False, "float32", "projection"),
]
# The kernels each entry must run, by I/O dtype (the C entries pick them):
# for attention, bf16 on the tensor cores, fp32 on the SIMT kernels (K11's
# backward starts with the di kernel in both); K1 its staged tile kernel,
# K3 its split lane walk, K2 and K4 the lane-split walks (K4: the local
# pass, the combine and the main pass) in both types, K5 and K6 their lane
# walks, K7 its split lane walk and K8 its three (local, combine, main) in
# both types. Checked by name from the profiler at every case. K9 and K10
# share a source, so each is checked against both entries' kernels.
ROUTES = {
    ("K1", "bfloat16"): ("short_bidir_fwd_tile_kernel",),
    ("K1", "float32"): ("short_bidir_fwd_tile_kernel",),
    ("K2", "bfloat16"): ("short_bidir_bwd_lanes_kernel",),
    ("K2", "float32"): ("short_bidir_bwd_lanes_kernel",),
    ("K3", "bfloat16"): ("chunked_scan_fwd_lanes",),
    ("K3", "float32"): ("chunked_scan_fwd_lanes",),
    ("K4", "bfloat16"): ("chunked_scan_bwd_local_lanes",
                         "chunked_scan_bwd_combine",
                         "chunked_scan_bwd_main_lanes"),
    ("K4", "float32"): ("chunked_scan_bwd_local_lanes",
                        "chunked_scan_bwd_combine",
                        "chunked_scan_bwd_main_lanes"),
    ("K5", "bfloat16"): ("short_scan_fwd_lanes",),
    ("K5", "float32"): ("short_scan_fwd_lanes",),
    ("K6", "bfloat16"): ("short_scan_bwd_lanes",),
    ("K6", "float32"): ("short_scan_bwd_lanes",),
    ("K7", "bfloat16"): ("complex_scan_fwd_lanes",),
    ("K7", "float32"): ("complex_scan_fwd_lanes",),
    ("K8", "bfloat16"): ("complex_scan_bwd_local_lanes",
                         "complex_scan_bwd_combine",
                         "complex_scan_bwd_main_lanes"),
    ("K8", "float32"): ("complex_scan_bwd_local_lanes",
                        "complex_scan_bwd_combine",
                        "complex_scan_bwd_main_lanes"),
    ("K9", "bfloat16"): ("vision_mha_mma_kernel",),
    ("K9", "float32"): ("row_mha_kernel",),
    ("K10", "bfloat16"): ("row_mha_mma_kernel",),
    ("K10", "float32"): ("row_mha_kernel",),
    ("K11", "bfloat16"): ("flash_mha_fwd_mma_kernel",),
    ("K11", "float32"): ("flash_mha_fwd_kernel",),
    ("K11 bwd", "bfloat16"): ("flash_mha_bwd_di",
                              "flash_mha_bwd_dkdv_mma_kernel",
                              "flash_mha_bwd_dq_mma_kernel"),
    ("K11 bwd", "float32"): ("flash_mha_bwd_di", "flash_mha_bwd_dkdv_kernel",
                             "flash_mha_bwd_dq_kernel"),
}
ROUTE_FAMILIES = (("K1",), ("K2",), ("K3",), ("K4",), ("K5",), ("K6",),
                  ("K7",), ("K8",), ("K9", "K10"), ("K11",), ("K11 bwd",))
# profiler sessions a route check may take before it fails: on an H100's
# machine, past this script's K4 phase (at the parent commit too), most
# padded sessions recorded no device activity for calls that ran (a
# quarter to a half recorded them, whatever the padding, up to 1 s), so a
# session that misses a kernel of the route is repeated (and K5's, K6's,
# K7's and K8's checks run in a fresh process: ``check_fresh_routes``)
ROUTE_SESSIONS = 40
# largest |kernel - plain| over each output's largest magnitude (at least
# 1), the forward (out, lse) and the backward (dq, dk, dv), on an H100
# 80GB HBM3 (PERF.md): fp32 sums in another order and an online max, read
# at most 1.8e-7 forward and 2.6e-6 backward, held at about ten times
# that; bf16 one to two bf16 ulps apart (the kernel rounds its weights
# before dividing by the row sum, the plain version after), read at most
# 4.6e-3 on the SIMT forward and 5.7e-3 on the tensor-core one (L 100,
# causal), held at the JAX tests' 2e-2. The log-sum-exp is fp32 on both
# sides whatever the I/O type, so it is held at the fp32 tolerance (read
# at most 1.8e-7 of its scale).
K11_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
K7_SOURCE = "video_mamba_suite_torch/csrc/complex_scan_fwd.cu"
K7_REPLACES = "video_mamba_suite_tpu/ops/selective_scan_pallas.py:1732"
K8_SOURCE = "video_mamba_suite_torch/csrc/complex_scan_bwd.cu"
K8_REPLACES = "video_mamba_suite_tpu/ops/selective_scan_pallas.py:1798"
# K7 against its plain version (output, last state, checkpoints): K3's
# options. The first two are the scan microbench shape of bench.py:139
# (``scan_mtok_s``: 8 x 2048 x 1024, 16 states) with complex A in fp32 and
# bf16; then the anti-causal walk with an initial state and two groups of
# B/C, a ragged case (37 steps, groups of 20 channels, 5 states, bf16), and
# one step. Then the split's edges (``SPLIT_CASES``): one row of the
# microbench (16 segments of 128 steps), reverse, with h0; 1001 steps at 96
# channels (8 segments of 128, the last 105, checkpoints inside each); 45
# channels in bf16 (element copies); 8 states in groups of 64 channels,
# reverse (16-byte B/C rows); 13 states, ragged, reverse, with h0 (lanes
# that hold no state); one step with h0. tests/test_torch_kernels_cuda.py
# runs the same cases.
SPLIT_CASES = [
    ("b1-reverse-h0", (1, 2048, 1024, 16), "float32",
     {"reverse": True, "h0": True}),
    ("l1001-h0", (3, 1001, 96, 16), "float32", {"h0": True}),
    ("d45-bf16", (2, 300, 45, 16), "bfloat16", {}),
    ("n8-grouped-reverse", (2, 200, 128, 8), "float32",
     {"groups": 2, "reverse": True}),
    ("n13-ragged-reverse-h0", (3, 150, 40, 13), "float32",
     {"reverse": True, "h0": True}),
    ("one-step-h0", (4, 1, 64, 16), "float32", {"h0": True}),
]
K7_CASES = [
    ("scan-bench", (8, 2048, 1024, 16), "float32", {}),
    ("scan-bench-bf16", (8, 2048, 1024, 16), "bfloat16", {}),
    ("reverse-h0-grouped", (2, 300, 64, 16), "float32",
     {"reverse": True, "h0": True, "groups": 2}),
    ("ragged", (3, 37, 40, 5), "bfloat16",
     {"h0": True, "groups": 2, "no_dz": True}),
    ("one-step", (2, 1, 8, 4), "float32", {"reverse": True}),
] + SPLIT_CASES
# K8 against its plain version (eleven gradients), with cotangents of the
# output and of both last-state channels: K7's cases, the bf16 microbench
# at one row (the plain version's autograd keeps every step's tensors).
K8_CASES = [
    ("scan-bench", (8, 2048, 1024, 16), "float32", {}),
    ("scan-bench-bf16-b1", (1, 2048, 1024, 16), "bfloat16", {}),
    ("reverse-h0-grouped", (2, 300, 64, 16), "float32",
     {"reverse": True, "h0": True, "groups": 2}),
    ("ragged", (3, 37, 40, 5), "bfloat16",
     {"h0": True, "groups": 2, "no_dz": True}),
    ("one-step", (2, 1, 8, 4), "float32", {"reverse": True}),
] + SPLIT_CASES
# each output within atol · (its largest magnitude) + rtol · |value|: K3's
# and K4's tolerances (fp32 sums and transcendentals in another order over
# thousands of steps; bf16 outputs one to two bf16 ulps apart). Read on an
# H100 80GB HBM3 (PERF.md), largest error over scale: K7 2.6e-7 fp32,
# 5.3e-4 bf16; K8 2.1e-6 fp32, 1.1e-3 bf16
K7_TOL = {"float32": (2e-4, 2e-4), "bfloat16": (2e-2, 2e-2)}
K8_TOL = {"float32": (2e-4, 2e-4), "bfloat16": (2e-2, 2e-2)}
# FusedMHA(flash=True) forward + backward: (label, batch, tokens, width,
# heads, causal, compute dtype), CLIP-TimeMamba-B's text tower and its
# spatial attention (flattened to 128 instances)
FLASH_MODULE_CASES = [
    ("text", 8, 77, 512, 8, True, "float32"),
    ("vision", 128, 197, 768, 12, False, "bfloat16"),
]
FLASH_MODULE_CALLS = 10          # timed forward + backward calls
# FusedMHA(flash="vmem") forward, the entry through which K9 is reached:
# (label, batch, tokens, width, heads, compute dtype) at CLIP-TimeMamba-B's
# spatial width flattened to 128 instances (K9's main case)
VMEM_MODULE_CASE = ("vision", 128, 197, 768, 12, "bfloat16")
VMEM_MODULE_CALLS = 20           # timed forward calls
# FusedMHA(flash=True) in fp32 (TF32 off), the card through K11 against the
# CPU's einsum path, each output's largest difference over its largest CPU
# magnitude: read 8.9e-7 (text) and 1.4e-6 (vision) on an H100 80GB HBM3
# (PERF.md), held at about ten times that
CARD_CPU_FLASH_REL_TOL = 1.5e-5
COMPLEX_SHAPE = (8, 2048, 1024, 16)   # bench.py:139, scan_mtok_s
COMPLEX_CALLS = 3                # timed forward + backward calls
# selective_scan with complex A, the card through K7 and K8 against the
# plain version on the card (fp32, 2 rows), each output's largest
# difference over its largest magnitude: read 2.1e-6 on an H100 80GB HBM3
# (PERF.md), held at about ten times that
COMPLEX_PLAIN_REL_TOL = 2e-5
MIR_REQUESTS = 10                # timed MIR serving requests
MIR_CAPTIONS = 8                 # captions per request
MIR_EVAL = 32                    # clips and captions of the evaluate phase
VISION_DEPTH = 12                # video-tower blocks (one K1, one K10 each)
# CLIP-TimeMamba-B at full width and depth (12 + 12), fp32, TF32 off, card
# against CPU, each output's largest difference over its largest CPU
# magnitude (video and text embeddings, the scale): read at most 1.4e-6
# (the text embeddings) on an H100 80GB HBM3 (PERF.md), held at about ten
# times that
CARD_CPU_CLIP_REL_TOL = 1.5e-5
TAL_STEPS = 10                   # timed ActionMamba train steps
TAL_EVAL_VIDEOS = 4              # synthetic THUMOS videos of the eval phase
TAL_MAX_GT = 32                  # ground-truth slots of a collated batch
# scan launches a train step (forward with checkpoints, backward): the
# THUMOS pyramid's seven DBM mixers at 2304, 2304, 2304, 1152, 576, 288
# and 144 steps, two directions each; ActivityNet's at 192 (three), 96 (a
# scan per direction) and 48, 24, 12 (one fused scan each)
TAL_THUMOS_LAUNCHES = {"chunked_scan_fwd": 14, "chunked_scan_bwd": 14}
TAL_ANET_LAUNCHES = {"chunked_scan_fwd": 8, "chunked_scan_bwd": 8,
                     "short_bidir_fwd": 3, "short_bidir_bwd": 3}
# ActionMamba at THUMOS-14's full width and depth, fp32, TF32 off, one
# video padded from 2000 to 2304 steps, the drop-path scales set to 1 so
# the mixers count: the card against the CPU, each level's logits and
# offsets by the largest difference over the largest CPU magnitude of
# their kind: read 1.6e-6 and 4.2e-6 on an H100 80GB HBM3 (PERF.md), held
# at about ten times that; each parameter's gradient over its largest CPU
# value: read 1.9e-4 (the first level's neck norm weight, a sum over
# 2304 steps through cuDNN's convolutions and the heads), held at about
# ten times that
CARD_CPU_TAL_REL_TOL = 4e-5
CARD_CPU_TAL_GRAD_REL_TOL = 2e-3
# the egocentric training paths and the rest of the LM
MIR_TRAIN_STEPS = 5              # timed MIR fine-tuning steps
PRETRAIN_BATCH = 32              # clips + captions a pretraining step on one
                                 # card (the preset's 256 is the whole job's)
PRETRAIN_STEPS = 5               # timed CLIP pretraining steps
CLS_STEPS = 5                    # timed EK100 classification steps
CLS_EVAL_CLIPS, CLS_EVAL_CROPS = 16, 2   # the classification evaluate
EK100_VERBS, EK100_NOUNS = 97, 300       # marginals of the 3806 actions
LL_BATCH, LL_LENGTH = 8, 1024    # perplexity: rows x tokens (K3)
LL_REQUESTS = 16                 # loglikelihood requests (contexts > 64)
CARD_CPU_MIR_DEPTH = 2           # video and text blocks of the card-vs-CPU
                                 # MIR step at full width
# the MIR fine-tuning step at full width, depth 2 + 2, fp32, TF32 off, card
# against CPU: the loss relative (read 0 on an H100 80GB HBM3, PERF.md),
# and each parameter's gradient's largest difference over its largest CPU
# value (read 1.6e-4, the second block's fc2 bias: a sum over 6272 tokens
# of a hinge loss's sparse gradient), held at about ten times that
CARD_CPU_MIR_REL_TOL = 1e-5
CARD_CPU_MIR_GRAD_REL_TOL = 2e-3
# the int8 Mamba-130M at full width and depth, card against CPU, the
# logits' largest difference over their largest CPU magnitude: read
# 1.1e-2 to 1.9e-2 (PERF.md). Its activations are bf16, whose rounding
# flips where the two sides' scans differ in the last fp32 bit, through
# 24 layers; held at about three times the reading
CARD_CPU_W8_REL_TOL = 5e-2
# ASFormer-Mamba (temporal action segmentation) and upstream checkpoints
TAS_STEPS = 5                    # timed TAS train steps of each preset
TAS_EVAL_VIDEOS = {"tas-gtea": 4, "tas-50salads": 2}  # videos of each
                                 # evaluate (the host's edit and F1 loops
                                 # grow with the segments of 6000 frames)
TAS_GTEA_LENGTH = 1500           # features of the GTEA phase's video
TAS_50SALADS_LENGTH = 6000       # 50Salads: 12000 frames at sample rate 2
TAS_LAYERS = 10                  # encoder layers: 2 K3 (and 2 K4) each
TAS_STEP_LAUNCHES = {"chunked_scan_fwd": 2 * TAS_LAYERS,
                     "chunked_scan_bwd": 2 * TAS_LAYERS}
CARD_CPU_TAS_DEPTH = 3           # encoder and decoder layers, card vs CPU
CARD_CPU_TAS_LENGTH = 300        # steps of its video
# one TAS step at full width, depth 3, one decoder, fp32, TF32 off, card
# against CPU: the loss relative; each gradient's largest difference over
# its largest CPU value, or over a hundredth of the model's largest
# gradient where its own is smaller (a key conv's bias gets a gradient of
# rounding noise: the softmax ignores a shift of all of a query's scores)
CARD_CPU_TAS_REL_TOL = 1e-5
CARD_CPU_TAS_GRAD_REL_TOL = 1e-3
CARD_CPU_TAS_GRAD_FLOOR = 1e-2
CKPT_SEED = 0                    # upstream state dicts of the ckpt-mir phase
CKPT_VIVIM_FRAMES = 8            # its ViViM-T checkpoint's temporal rows
VTG_STEPS = 5                    # timed UniVTG-Mamba steps of each cell
VTG_LAYERS = 6                   # DBM layers of the presets: 2 K3 (2 K4) each
VTG_STEP_LAUNCHES = {"chunked_scan_fwd": 2 * VTG_LAYERS,
                     "chunked_scan_bwd": 2 * VTG_LAYERS}
VTG_QUERY_TOKENS = 16            # query tokens of a synthetic QVHighlights
                                 # sample (padded to the preset's 32)
VTG_EVAL_SAMPLES = 32            # samples of the evaluate phase (4 batches)
VTG_PREDICTS = 5                 # timed predict batches of 8
TVSUM_EVAL_VIDEOS = 4            # synthetic videos of the TVSum eval
TVSUM_ANNOTATORS = 20            # the TVSum protocol's annotators
VLP_CLASSES = 20                 # class names of the zero-shot phase
VLP_CLASS_TOKENS = 8             # tokens of a class name
QFVS_ITEMS = 4                   # QFVS items of a step (3 x 8 frames each)
QFVS_STEP_LAUNCHES = {"short_bidir_fwd": 3 * VTG_LAYERS,
                      "short_bidir_bwd": 3 * VTG_LAYERS}
CARD_CPU_VTG_DEPTH = 2           # layers of the card-vs-CPU UniVTG-Mamba
CARD_CPU_VTG_BATCH = 8           # its samples (107 steps each)
# card against CPU, fp32 with TF32 off: forward outputs within 1e-5 of
# their scale and the losses within 1e-5; gradients as the TAS step's,
# within 1e-3 of each parameter's scale (floor 1e-2 of the largest)
CARD_CPU_VTG_REL_TOL = 1e-5
CARD_CPU_VTG_GRAD_REL_TOL = 1e-3
CARD_CPU_VTG_GRAD_FLOOR = 1e-2
DVC_STEPS = 10                   # timed PDVC-Mamba steps of each preset
DVC_ENCODER_LAYERS = 2           # ViM layers of the presets: 2 K3 (2 K4) each
DVC_STEP_LAUNCHES = {"chunked_scan_fwd": 2 * DVC_ENCODER_LAYERS,
                     "chunked_scan_bwd": 2 * DVC_ENCODER_LAYERS}
DVC_VIDEOS = {"dvc-anet": 16, "dvc-yc2": 4}   # synthetic videos of a phase
DVC_FEATURES = (120, 400)        # features a video: subsampled and padded
DVC_EVENTS = (1, 10)             # events a video
DVC_WORDS = (6, 20)              # words an event's sentence
DVC_CORPUS_WORDS = 400           # distinct words of the synthetic corpus
DVC_PREDICTS = 5                 # timed predict batches
DVC_SYNTH_STEPS = 200            # steps of the JAX CLI's synthetic task
DVC_SYNTH_BBOX = 0.2             # its last loss_bbox must fall under this
# full-width fp32 PDVC-Mamba (ActivityNet preset, TF32 off) card against
# CPU: the forward's outputs and the caption head's logits (from the same
# inputs) within 1e-5 of their scale, each loss term within 1e-5
# relative, each gradient within 1e-3 of the parameter's largest (floor
# 1e-2 of the largest of all: the attention key bias and the DSA head's
# alpha_net bias have an exact gradient of 0)
CARD_CPU_DVC_REL_TOL = 1e-5
CARD_CPU_DVC_GRAD_REL_TOL = 1e-3
CARD_CPU_DVC_GRAD_FLOOR = 1e-2
LM_INT8_REQUESTS = 3             # timed requests of each int8 / bf16 leg
LM_PROFILE_NEW = 16              # new tokens of a profiled LM request (the
                                 # profiler's processing of a 128-token
                                 # request's events takes over a minute)


def log(*a):
    print(*a, flush=True)


START = time.perf_counter()


def mark(phase):
    """The script's wall time when ``phase`` ends."""
    log(f"[time] {phase} done at {time.perf_counter() - START:.1f} s")


def clip_shape():
    """(frames, height, width, channels) of one TimeMamba-B clip."""
    from video_mamba_suite_torch.configs import TIMEMAMBA_B

    img = TIMEMAMBA_B["img_size"]
    return TIMEMAMBA_B["num_frames"], img, img, 3


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean ms per call: launches back to back on the current stream between
    two CUDA events, synchronised before the events are read."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# K1: fused bidirectional short scan


def k1_inputs(shape, dtype, seed, has_dz=True, device="cuda", shared=False):
    """Seeded inputs of K1 at (batch, seqlen, dim, dstate); ``dtype`` names
    the I/O dtype (A, D and bias are fp32). ``shared``: Ab, Db and biasb
    are the tensors Af, Df and biasf, as the DBM mixer passes them."""
    import torch

    batch, seqlen, dim, dstate = shape
    io_dtype = getattr(torch, dtype)
    g = torch.Generator(device=device).manual_seed(seed)

    def normal(*s):
        return torch.randn(*s, device=device, generator=g)

    def unif(*s):
        return torch.rand(*s, device=device, generator=g)

    io = {}
    for s in "fb":
        io["u" + s] = normal(batch, seqlen, dim).to(io_dtype)
        io["dt" + s] = (0.5 * unif(batch, seqlen, dim)).to(io_dtype)
        io["z" + s] = normal(batch, seqlen, dim).to(io_dtype)
        io["B" + s] = normal(batch, seqlen, dstate).to(io_dtype)
        io["C" + s] = normal(batch, seqlen, dstate).to(io_dtype)
        io["A" + s] = -0.5 * unif(dim, dstate)
        io["D" + s] = normal(dim)
        io["bias" + s] = 0.5 * unif(dim)
    if shared:
        for k in ("A", "D", "bias"):
            io[k + "b"] = io[k + "f"]
    if not has_dz:
        for k in ("Df", "Db", "zf", "zb"):
            del io[k]
    return io


def k1_check(label, shape, dtype, has_dz, shared=False):
    """Launch K1 once on the card at one of ``K1_CASES`` and hold it against
    its plain version. Returns (inputs, outputs, max_abs_err, max_rel_err);
    raises AssertionError on a miss."""
    import torch
    from video_mamba_suite_torch.ops import (
        LAUNCHES,
        selective_scan_bidir,
        selective_scan_bidir_ref,
    )

    args = k1_inputs(shape, dtype, seed=sum(shape), has_dz=has_dz,
                     shared=shared)
    n0 = LAUNCHES["short_bidir_fwd"]
    got = selective_scan_bidir(**args)
    torch.cuda.synchronize()
    if LAUNCHES["short_bidir_fwd"] != n0 + 1:
        raise AssertionError("K1's wrapper did not count its launch")
    want = selective_scan_bidir_ref(**args)
    atol, rtol = K1_TOL[dtype]
    for g, w in zip(got, want):
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"K1 at {label}: got {g.dtype} "
                                 f"{tuple(g.shape)}, want {w.dtype} "
                                 f"{tuple(w.shape)}")
    diff = [(g.float() - w.float()).abs() for g, w in zip(got, want)]
    err = max(d.max().item() for d in diff)
    rel = max((d / w.float().abs().clamp_min(1e-6)).max().item()
              for d, w in zip(diff, want))
    ok = all(torch.allclose(g.float(), w.float(), atol=atol, rtol=rtol)
             for g, w in zip(got, want))
    log(f"[k1] {label} {shape} {dtype}{'' if has_dz else ' no D/z'}"
        f"{' shared A/D/bias' if shared else ''}: "
        f"max_abs_err {err:.3e} max_rel_err {rel:.3e} (tol atol {atol} "
        f"rtol {rtol}) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"K1 disagrees with its plain version at "
                             f"{label} {shape}")
    return args, got, err, rel


def k1_bound_ms(args, out):
    """Least time for the work and what sets it: each input read once and
    each output written once over HBM, against 6 fp32 operations per state
    update and direction. Also logs a third reading, outside the bound: one
    exponential per state update over the special function units' rate."""
    unique = {id(t): t for t in args.values()}.values()   # shared A, D, bias
    nbytes = sum(t.numel() * t.element_size() for t in unique)
    nbytes += sum(t.numel() * t.element_size() for t in out)
    batch, seqlen, dim = args["uf"].shape
    updates = 2.0 * batch * seqlen * dim * args["Bf"].shape[-1]
    ops = 6.0 * updates
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOP_PER_S
    log(f"[k1] bound: {nbytes / 1e6:.1f} MB over 3.35 TB/s = "
        f"{1e3 * t_bytes:.4f} ms; {ops / 1e9:.2f} GFLOP over 67 TFLOP/s = "
        f"{1e3 * t_ops:.4f} ms; {updates / 1e6:.1f} M exponentials over "
        f"{SFU_PER_S / 1e12:.2f} T/s = {1e3 * updates / SFU_PER_S:.4f} ms")
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else \
        "operations"


def check_k1():
    """Every case of ``K1_CASES`` with the kernel the profiler saw run
    (``ROUTES``) and its device time; the main-path case is also timed."""
    from video_mamba_suite_torch.ops import (
        selective_scan_bidir,
        selective_scan_bidir_ref,
    )

    log_resources("short_bidir_fwd", "k1")
    result = {}
    for case in K1_CASES:
        args, got, err, _ = k1_check(*case)
        check_scan_route("K1", case[0], case[2],
                         lambda: selective_scan_bidir(**args), "k1")
        if case[0] == "main" or case[4]:     # and the DBM mixer's case
            timed = dict(max_abs_err=err, ms=cuda_time_ms(
                lambda: selective_scan_bidir(**args), iters=50))
            timed["plain_ms"] = cuda_time_ms(
                lambda: selective_scan_bidir_ref(**args), iters=5, warmup=1)
            timed["bound_ms"], timed["bound_by"] = k1_bound_ms(args, got)
            log(f"[k1] {case[0]}: kernel {timed['ms']:.4f} ms, plain "
                f"{timed['plain_ms']:.4f} ms, bound "
                f"{timed['bound_ms']:.4f} ms ({timed['bound_by']})")
            if case[0] == "main":
                result = timed
    return result


# ---------------------------------------------------------------------------
# K2: its adjoint


def k2_inputs(shape, dtype, seed, has_dz=True, device="cuda", shared=False):
    """K1's inputs at one of ``K2_CASES`` and the two cotangents."""
    import torch

    args = k1_inputs(shape, dtype, seed, has_dz, device, shared)
    g = torch.Generator(device=device).manual_seed(seed + 1)
    batch, seqlen, dim, _ = shape
    cot = {k: torch.randn(batch, seqlen, dim, device=device,
                          generator=g).to(getattr(torch, dtype))
           for k in ("gf", "gb")}
    return args, cot


def k2_check(label, shape, dtype, has_dz, shared=False):
    """Launch K2 once on the card at one of ``K2_CASES`` and hold its 16
    gradients against the plain version's; with ``shared`` also the
    gradients autograd sums into the shared A, D and bias
    (``k2_shared_check``). Returns (inputs, cotangents, gradients,
    max_abs_err); raises AssertionError on a miss."""
    import torch
    from video_mamba_suite_torch.ops import (
        LAUNCHES,
        selective_scan_bidir_bwd,
        selective_scan_bidir_bwd_ref,
    )

    args, cot = k2_inputs(shape, dtype, seed=sum(shape) + 7, has_dz=has_dz,
                          shared=shared)
    n0 = LAUNCHES["short_bidir_bwd"]
    got = selective_scan_bidir_bwd(**args, **cot)
    torch.cuda.synchronize()
    if LAUNCHES["short_bidir_bwd"] != n0 + 1:
        raise AssertionError("K2's wrapper did not count its launch")
    want = selective_scan_bidir_bwd_ref(**args, **cot)
    atol, rtol = K2_TOL[dtype]
    names = [n + s for s in "fb"
             for n in ("du", "ddt", "dA", "dB", "dC", "dD", "dz", "dbias")]
    abs_err, rel, worst, ok = 0.0, 0.0, "", True
    for name, g, w in zip(names, got, want):
        if (g is None) != (w is None):
            raise AssertionError(f"K2 at {label}: {name} is {g} against "
                                 f"{w}")
        if g is None:
            continue
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"K2 at {label}: {name} {g.dtype} "
                                 f"{tuple(g.shape)}, want {w.dtype} "
                                 f"{tuple(w.shape)}")
        d = (g.float() - w.float()).abs()
        scale = w.float().abs().max().item()
        bad = d > atol * scale + rtol * w.float().abs()
        if bad.any() or not (torch.isfinite(g).all()
                             and torch.isfinite(w).all()):
            ok = False
            log(f"[k2] {label}: {name} misses at {int(bad.sum())} of "
                f"{g.numel()} (max abs err {d.max().item():.3e}, scale "
                f"{scale:.3e})")
        abs_err = max(abs_err, d.max().item())
        if d.max().item() / max(scale, 1e-30) >= rel:
            rel, worst = d.max().item() / max(scale, 1e-30), name
    log(f"[k2] {label} {shape} {dtype}{'' if has_dz else ' no D/z'}: "
        f"max_abs_err {abs_err:.3e}, largest error over scale {rel:.3e} "
        f"({worst}) (tol atol {atol}·scale, rtol {rtol}) "
        f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"K2 disagrees with its plain version at "
                             f"{label} {shape}")
    if shared:
        k2_shared_check(label, args, cot, got, dtype)
    return args, cot, got, abs_err


def k2_shared_check(label, args, cot, got, dtype):
    """With A, D and bias one tensor in both directions (the DBM mixer's
    shared parameters): K2's two slots of each must not share storage, and
    a backward through K1/K2's autograd ``Function`` must sum both
    directions' gradients into each shared tensor (and give u and dt of
    each direction theirs) as the plain version's autograd does, within
    ``K2_TOL`` of each gradient's largest magnitude."""
    import torch
    from video_mamba_suite_torch.ops import (
        selective_scan_bidir,
        selective_scan_bidir_ref,
    )

    for i, name in ((2, "A"), (5, "D"), (7, "bias")):
        f, b = got[i], got[8 + i]
        if f is not None and f.data_ptr() == b.data_ptr():
            raise AssertionError(f"K2 at {label}: d{name}f and d{name}b "
                                 "share storage")

    def grads(fn):
        leaves = {k: v.detach().clone().requires_grad_()
                  for k, v in args.items()
                  if not (k[-1] == "b" and k[:-1] in ("A", "D", "bias"))}
        call = dict(leaves)
        for k in ("A", "D", "bias"):
            if k + "f" in leaves:
                call[k + "b"] = leaves[k + "f"]
        outs = fn(**call)
        torch.autograd.backward(outs, (cot["gf"], cot["gb"]))
        return {k: v.grad for k, v in leaves.items()}

    have = grads(selective_scan_bidir)
    want = grads(selective_scan_bidir_ref)
    atol, rtol = K2_TOL[dtype]
    worst, ok = 0.0, True
    for k, w in want.items():
        h = have[k]
        if h is None or w is None:
            raise AssertionError(f"K2 at {label} (shared): {k} got no "
                                 "gradient")
        d = (h.float() - w.float()).abs()
        scale = w.float().abs().max().item()
        bad = d > atol * scale + rtol * w.float().abs()
        if bad.any() or not torch.isfinite(h).all():
            ok = False
            log(f"[k2] {label} shared: {k} misses at {int(bad.sum())} of "
                f"{h.numel()} (max abs err {d.max().item():.3e}, scale "
                f"{scale:.3e})")
        worst = max(worst, d.max().item() / max(scale, 1e-30))
    log(f"[k2] {label} shared A/D/bias through autograd: largest error "
        f"over scale {worst:.3e} over {len(want)} gradients "
        f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"K2's autograd disagrees with the plain "
                             f"version at {label} with shared parameters")


def k2_bound_ms(args, cot, grads):
    """Least time for the work and what sets it: each input and cotangent
    read once and each gradient written once over HBM, against 20 fp32
    operations per state update and direction (the forward state, the
    gate's y, and the adjoint step's dh, dA, ddt, dB, dC and du terms)."""
    unique = {id(t): t for t in (*args.values(), *cot.values())}.values()
    nbytes = sum(t.numel() * t.element_size() for t in unique)
    nbytes += sum(t.numel() * t.element_size() for t in grads
                  if t is not None)
    batch, seqlen, dim = args["uf"].shape
    ops = 2 * 20.0 * batch * seqlen * dim * args["Bf"].shape[-1]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOP_PER_S
    log(f"[k2] bound: {nbytes / 1e6:.1f} MB over 3.35 TB/s = "
        f"{1e3 * t_bytes:.4f} ms; {ops / 1e9:.2f} GFLOP over 67 TFLOP/s = "
        f"{1e3 * t_ops:.4f} ms")
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else \
        "operations"


def log_resources(source, tag):
    """Registers and spills of ``source``'s kernels (``RESOURCE_KERNELS``)
    from its build log."""
    from video_mamba_suite_torch.ops import _build

    for kernel, regs, stores, loads in kernel_resources(
            _build.build_log(source)):
        log(f"[{tag}] {kernel}: {regs} registers, {stores} bytes spill "
            f"stores, {loads} bytes spill loads")


def check_scan_route(kernel, label, dtype, fn, tag):
    """Profile three calls of ``fn``, again (up to ``ROUTE_SESSIONS``
    sessions) until a session records every kernel of ``kernel``'s route
    at ``dtype``: raise unless those kernels ran, and log each one's
    device ms per call."""
    want = ROUTES[(kernel, dtype)]
    for _ in range(ROUTE_SESSIONS):
        device = profile("call", fn, tag=tag, calls=3, top=0)
        if all(any(runs(k, n) for n in device) for k in want):
            break
        time.sleep(0.1)
    check_route(kernel, label, dtype,
                route_names(fn, device, (kernel, dtype)))
    split = route_split(kernel, dtype, device)
    log(f"[{tag}] {label}: device ms per call " + ", ".join(
        f"{k} {ms:.4f}" for k, ms in split) +
        f" (total {sum(ms for _, ms in split):.4f})")


def check_k2():
    """Every case of ``K2_CASES`` with the kernel the profiler saw run
    (``ROUTES``) and its device time; the main-path case is also timed."""
    from video_mamba_suite_torch.ops import (
        selective_scan_bidir_bwd,
        selective_scan_bidir_bwd_ref,
    )

    log_resources("short_bidir_bwd", "k2")
    result = {}
    for case in K2_CASES:
        args, cot, got, err = k2_check(*case)
        check_scan_route("K2", case[0], case[2],
                         lambda: selective_scan_bidir_bwd(**args, **cot),
                         "k2")
        if case[0] == "main" or case[4]:     # and the DBM mixer's case
            timed = dict(max_abs_err=err, ms=cuda_time_ms(
                lambda: selective_scan_bidir_bwd(**args, **cot), iters=20))
            timed["plain_ms"] = cuda_time_ms(
                lambda: selective_scan_bidir_bwd_ref(**args, **cot),
                iters=3, warmup=1)
            timed["bound_ms"], timed["bound_by"] = k2_bound_ms(
                args, cot, got)
            log(f"[k2] {case[0]}: kernel {timed['ms']:.4f} ms, plain "
                f"{timed['plain_ms']:.4f} ms, bound "
                f"{timed['bound_ms']:.4f} ms ({timed['bound_by']})")
            if case[0] == "main":
                result = timed
    return result


# ---------------------------------------------------------------------------
# K3: chunked selective scan, one direction


def k3_inputs(shape, dtype, seed, reverse=False, h0=False, groups=0,
              no_dz=False, device="cuda"):
    """Seeded keyword arguments of ``chunked_scan_fwd`` at one of
    ``K3_CASES``; ``dtype`` names the I/O dtype (A, D, the bias and the
    initial state are fp32)."""
    import torch

    batch, seqlen, dim, dstate = shape
    io_dtype = getattr(torch, dtype)
    g = torch.Generator(device=device).manual_seed(seed)

    def normal(*s):
        return torch.randn(*s, device=device, generator=g)

    def unif(*s):
        return torch.rand(*s, device=device, generator=g)

    bc = (batch, seqlen, groups, dstate) if groups else (batch, seqlen,
                                                         dstate)
    args = dict(
        u=normal(batch, seqlen, dim).to(io_dtype),
        delta=(0.5 * unif(batch, seqlen, dim)).to(io_dtype),
        A=-0.5 * unif(dim, dstate),
        B=normal(*bc).to(io_dtype), C=normal(*bc).to(io_dtype),
        D=None if no_dz else normal(dim),
        z=None if no_dz else normal(batch, seqlen, dim).to(io_dtype),
        delta_bias=0.5 * unif(dim),
        initial_state=normal(batch, dim, dstate) if h0 else None,
        delta_softplus=True, reverse=reverse)
    return args


def k3_check(label, shape, dtype, opts):
    """Launch K3 once on the card at one of ``K3_CASES`` and hold its output
    and last state against the plain version's. Returns (inputs, outputs,
    max_abs_err); raises AssertionError on a miss."""
    import torch
    from video_mamba_suite_torch.ops import (
        CHECKPOINT_STEPS,
        LAUNCHES,
        chunked_scan_fwd,
        chunked_scan_states_ref,
        selective_scan_ref,
    )

    args = k3_inputs(shape, dtype, seed=sum(shape), **opts)
    n0 = LAUNCHES["chunked_scan_fwd"]
    got = chunked_scan_fwd(**args, checkpoint_steps=CHECKPOINT_STEPS)
    torch.cuda.synchronize()
    if LAUNCHES["chunked_scan_fwd"] != n0 + 1:
        raise AssertionError("K3's wrapper did not count its launch")
    plain = {k: v for k, v in args.items() if k not in ("D", "z")}
    want = (*selective_scan_ref(**args, return_last_state=True),
            chunked_scan_states_ref(**plain,
                                    checkpoint_steps=CHECKPOINT_STEPS))
    atol, rtol = K3_TOL[dtype]
    abs_err, worst, ok = 0.0, 0.0, True
    for name, g, w in zip(("out", "last state", "checkpoints"), got, want):
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"K3 at {label}: {name} {g.dtype} "
                                 f"{tuple(g.shape)}, want {w.dtype} "
                                 f"{tuple(w.shape)}")
        d = (g.float() - w.float()).abs()
        scale = w.float().abs().max().item()
        bad = d > atol * scale + rtol * w.float().abs()
        if bad.any() or not (torch.isfinite(g).all()
                             and torch.isfinite(w).all()):
            ok = False
            log(f"[k3] {label}: {name} misses at {int(bad.sum())} of "
                f"{g.numel()} (max abs err {d.max().item():.3e}, scale "
                f"{scale:.3e})")
        abs_err = max(abs_err, d.max().item())
        worst = max(worst, d.max().item() / max(scale, 1e-30))
    log(f"[k3] {label} {shape} {dtype} {opts or ''}: max_abs_err "
        f"{abs_err:.3e}, largest error over scale {worst:.3e} (tol atol "
        f"{atol}·scale, rtol {rtol}) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"K3 disagrees with its plain version at "
                             f"{label} {shape}")
    return args, got[:2], abs_err


def k3_bound_ms(args, outs):
    """Least time for the work and what sets it: each input read once and
    each output written once over HBM, against 6 fp32 operations per state
    update (the exponential counted as one). Also logs a third reading,
    outside the bound: one exponential per state update over the special
    function units' rate."""
    import torch

    tensors = [t for t in (*args.values(), *outs)
               if isinstance(t, torch.Tensor)]
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    batch, seqlen, dim = args["u"].shape
    updates = 1.0 * batch * seqlen * dim * args["A"].shape[1]
    ops = 6.0 * updates
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOP_PER_S
    log(f"[k3] bound: {nbytes / 1e6:.1f} MB over 3.35 TB/s = "
        f"{1e3 * t_bytes:.4f} ms; {ops / 1e9:.3f} GFLOP over 67 TFLOP/s = "
        f"{1e3 * t_ops:.4f} ms; {updates / 1e6:.1f} M exponentials over "
        f"{SFU_PER_S / 1e12:.2f} T/s = {1e3 * updates / SFU_PER_S:.4f} ms")
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else \
        "operations"


def check_k3():
    """Every case of ``K3_CASES``, each with the kernel the profiler saw run
    (``ROUTES``) and its device time, the kernel's time with and without
    checkpoints, the plain version's (two calls: it loops over the steps)
    and the bound. Returns the main-path case's (the first) numbers."""
    from video_mamba_suite_torch.ops import (
        CHECKPOINT_STEPS,
        chunked_scan_fwd,
        selective_scan_ref,
    )

    log_resources("chunked_scan_fwd", "k3")
    result = {}
    for case in K3_CASES:
        args, got, err = k3_check(*case)
        check_scan_route("K3", case[0], case[2],
                         lambda: chunked_scan_fwd(**args), "k3")
        ms = cuda_time_ms(lambda: chunked_scan_fwd(**args), iters=20)
        plain_ms = cuda_time_ms(lambda: selective_scan_ref(**args), iters=1,
                                warmup=1)
        bound_ms, bound_by = k3_bound_ms(args, got)
        ck_ms = cuda_time_ms(lambda: chunked_scan_fwd(
            **args, checkpoint_steps=CHECKPOINT_STEPS), iters=20)
        log(f"[k3] {case[0]}: kernel {ms:.4f} ms ({ck_ms:.4f} ms writing "
            f"checkpoints every {CHECKPOINT_STEPS} steps), plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
        if not result:
            result = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by)
    return result


# ---------------------------------------------------------------------------
# K4: its adjoint


def k4_inputs(shape, dtype, seed, **opts):
    """K3's inputs at one of ``K4_CASES``, its checkpoints (every
    ``CHECKPOINT_STEPS`` steps, from K3) and the cotangents of the output
    and of the last state. Returns (arguments of ``chunked_scan_bwd_ref``,
    the checkpoints)."""
    import torch
    from video_mamba_suite_torch.ops import CHECKPOINT_STEPS, chunked_scan_fwd

    args = k3_inputs(shape, dtype, seed, **opts)
    _, _, states = chunked_scan_fwd(**args,
                                    checkpoint_steps=CHECKPOINT_STEPS)
    batch, seqlen, dim, dstate = shape
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    args["g"] = torch.randn(batch, seqlen, dim, device="cuda",
                            generator=g).to(getattr(torch, dtype))
    args["g_last"] = torch.randn(batch, dim, dstate, device="cuda",
                                 generator=g)
    return args, states


def k4_check(label, shape, dtype, opts):
    """Launch K4 once on the card at one of ``K4_CASES`` and hold its nine
    gradients against the plain version's, whose one call is timed
    between CUDA events (an eager loop of seconds at the long cases: the
    plain time). Returns (arguments, checkpoints, gradients, max_abs_err,
    plain ms); raises AssertionError on a miss."""
    import torch
    from video_mamba_suite_torch.ops import (
        LAUNCHES,
        chunked_scan_bwd,
        chunked_scan_bwd_ref,
    )

    args, states = k4_inputs(shape, dtype, seed=sum(shape) + 11, **opts)
    n0 = LAUNCHES["chunked_scan_bwd"]
    got = chunked_scan_bwd(**args, states=states)
    torch.cuda.synchronize()
    if LAUNCHES["chunked_scan_bwd"] != n0 + 1:
        raise AssertionError("K4's wrapper did not count its launch")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    want = chunked_scan_bwd_ref(**args)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    atol, rtol = K4_TOL[dtype]
    names = ("du", "ddelta", "dA", "dB", "dC", "dD", "dz", "ddelta_bias",
             "dinitial_state")
    abs_err, rel, worst, ok = 0.0, 0.0, "", True
    for name, g, w in zip(names, got, want):
        if (g is None) != (w is None):
            raise AssertionError(f"K4 at {label}: {name} is {g} against "
                                 f"{w}")
        if g is None:
            continue
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"K4 at {label}: {name} {g.dtype} "
                                 f"{tuple(g.shape)}, want {w.dtype} "
                                 f"{tuple(w.shape)}")
        d = (g.float() - w.float()).abs()
        scale = w.float().abs().max().item()
        bad = d > atol * scale + rtol * w.float().abs()
        if bad.any() or not (torch.isfinite(g).all()
                             and torch.isfinite(w).all()):
            ok = False
            log(f"[k4] {label}: {name} misses at {int(bad.sum())} of "
                f"{g.numel()} (max abs err {d.max().item():.3e}, scale "
                f"{scale:.3e})")
        abs_err = max(abs_err, d.max().item())
        if d.max().item() / max(scale, 1e-30) >= rel:
            rel, worst = d.max().item() / max(scale, 1e-30), name
    log(f"[k4] {label} {shape} {dtype} {opts or ''}: max_abs_err "
        f"{abs_err:.3e}, largest error over scale {rel:.3e} ({worst}) (tol "
        f"atol {atol}·scale, rtol {rtol}) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"K4 disagrees with its plain version at "
                             f"{label} {shape}")
    return args, states, got, abs_err, plain_ms


def k4_bound_ms(args, states, grads):
    """Least time for the work and what sets it: each input (the
    checkpoints and both cotangents included) read once and each gradient
    written once over HBM, against 18 fp32 operations per state update
    (6 for the forward recompute, 12 for the adjoint step)."""
    import torch

    tensors = [t for t in (*args.values(), states, *grads)
               if isinstance(t, torch.Tensor)]
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    batch, seqlen, dim = args["u"].shape
    ops = 18.0 * batch * seqlen * dim * args["A"].shape[1]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOP_PER_S
    log(f"[k4] bound: {nbytes / 1e6:.1f} MB over 3.35 TB/s = "
        f"{1e3 * t_bytes:.4f} ms; {ops / 1e9:.3f} GFLOP over 67 TFLOP/s = "
        f"{1e3 * t_ops:.4f} ms")
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else \
        "operations"


def check_k4():
    """Every case of ``K4_CASES``, each with the kernels the profiler saw
    run (``ROUTES``: the local pass, the combine and the main pass, each
    with its device time), the kernel's time, the plain version's (its
    one call in ``k4_check``: an eager loop and its autograd) and the
    bound. Returns the main-path case's (the first) numbers."""
    from video_mamba_suite_torch.ops import chunked_scan_bwd

    log_resources("chunked_scan_bwd", "k4")
    result = {}
    for case in K4_CASES:
        args, states, got, err, plain_ms = k4_check(*case)
        check_scan_route("K4", case[0], case[2],
                         lambda: chunked_scan_bwd(**args, states=states),
                         "k4")
        ms = cuda_time_ms(lambda: chunked_scan_bwd(**args, states=states),
                          iters=10)
        bound_ms, bound_by = k4_bound_ms(args, states, got)
        log(f"[k4] {case[0]}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by})")
        if not result:
            result = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by)
    return result


# ---------------------------------------------------------------------------
# K5: short selective scan, one direction


def k5_inputs(shape, dtype, seed, **opts):
    """Seeded keyword arguments of ``short_scan_fwd`` at one of
    ``K5_CASES`` (K3's inputs, no initial state)."""
    args = k3_inputs(shape, dtype, seed, **opts)
    del args["initial_state"]
    return args


def k5_check(label, shape, dtype, opts):
    """Launch K5 once on the card at one of ``K5_CASES`` and hold its output
    and last state against the plain version's. Returns (inputs, outputs,
    max_abs_err); raises AssertionError on a miss."""
    import torch
    from video_mamba_suite_torch.ops import (
        LAUNCHES,
        short_scan_fwd,
        short_scan_fwd_ref,
    )

    args = k5_inputs(shape, dtype, seed=sum(shape) + 3, **opts)
    n0 = LAUNCHES["short_scan_fwd"]
    got = short_scan_fwd(**args)
    torch.cuda.synchronize()
    if LAUNCHES["short_scan_fwd"] != n0 + 1:
        raise AssertionError("K5's wrapper did not count its launch")
    want = short_scan_fwd_ref(**args)
    abs_err, worst, ok = 0.0, 0.0, True
    for name, g, w, (atol, rtol) in zip(
            ("out", "last state"), got, want,
            (K5_TOL[dtype], K5_TOL["float32"])):
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"K5 at {label}: {name} {g.dtype} "
                                 f"{tuple(g.shape)}, want {w.dtype} "
                                 f"{tuple(w.shape)}")
        d = (g.float() - w.float()).abs()
        scale = w.float().abs().max().item()
        bad = d > atol * scale + rtol * w.float().abs()
        if bad.any() or not (torch.isfinite(g).all()
                             and torch.isfinite(w).all()):
            ok = False
            log(f"[k5] {label}: {name} misses at {int(bad.sum())} of "
                f"{g.numel()} (max abs err {d.max().item():.3e}, scale "
                f"{scale:.3e})")
        abs_err = max(abs_err, d.max().item())
        worst = max(worst, d.max().item() / max(scale, 1e-30))
    log(f"[k5] {label} {shape} {dtype} {opts or ''}: max_abs_err "
        f"{abs_err:.3e}, largest error over scale {worst:.3e} (tol atol "
        f"{K5_TOL[dtype][0]}·scale, rtol {K5_TOL[dtype][1]}; last state "
        f"as fp32) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"K5 disagrees with its plain version at "
                             f"{label} {shape}")
    return args, got, abs_err


def k5_bound_ms(args, outs):
    """Least time for the work and what sets it: each input read once and
    each output written once over HBM, against 6 fp32 operations per state
    update (the exponential counted as one)."""
    import torch

    tensors = [t for t in (*args.values(), *outs)
               if isinstance(t, torch.Tensor)]
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    batch, seqlen, dim = args["u"].shape
    ops = 6.0 * batch * seqlen * dim * args["A"].shape[1]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOP_PER_S
    log(f"[k5] bound: {nbytes / 1e6:.3f} MB over 3.35 TB/s = "
        f"{1e3 * t_bytes:.5f} ms; {ops / 1e9:.4f} GFLOP over 67 TFLOP/s = "
        f"{1e3 * t_ops:.5f} ms")
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else \
        "operations"


def source_ms(device, source):
    """The device ms per call of the kernels of ``source`` (a C entry's
    name, which every kernel of the source carries: the first forms' and
    the redesigns' alike, so that a parent tree is timed the same way) in
    a profile's per-kernel times."""
    return sum(ms for key, ms in device.items() if source in key)


def check_k5():
    """Every case of ``K5_CASES``, each with the kernel's time (back to
    back between CUDA events, and its device time alone from the
    profiler), the plain version's and the bound; the kernel's registers
    and spills. The kernel the profiler saw run at each case comes from
    ``check_fresh_routes``. Returns the main-path case's (the first)
    numbers."""
    from video_mamba_suite_torch.ops import short_scan_fwd, short_scan_fwd_ref

    log_resources("short_scan_fwd", "k5")
    result = {}
    for case in K5_CASES:
        args, got, err = k5_check(*case)
        ms = cuda_time_ms(lambda: short_scan_fwd(**args), iters=100)
        device = profile("call", lambda: short_scan_fwd(**args), tag="k5",
                         calls=20, top=0)
        device_ms = source_ms(device, "short_scan_fwd")
        plain_ms = cuda_time_ms(lambda: short_scan_fwd_ref(**args), iters=3,
                                warmup=1)
        bound_ms, bound_by = k5_bound_ms(args, got)
        log(f"[k5] {case[0]}: kernel {ms:.5f} ms per call back to back "
            f"({device_ms:.5f} ms of device time per launch), plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by})")
        if not result:
            result = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=None)
    return result


# ---------------------------------------------------------------------------
# K6: the short one-direction scan's adjoint


def k6_inputs(shape, dtype, seed, **opts):
    """K5's inputs at one of ``K6_CASES`` and the output's cotangent ``g``
    (the arguments of ``short_scan_bwd``)."""
    import torch

    args = k5_inputs(shape, dtype, seed, **opts)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    args["g"] = torch.randn(*shape[:3], device="cuda",
                            generator=gen).to(getattr(torch, dtype))
    return args


def k6_check(label, shape, dtype, opts):
    """Launch K6 once on the card at one of ``K6_CASES`` and hold its eight
    gradients against the plain version's. Returns (arguments, gradients,
    max_abs_err); raises AssertionError on a miss."""
    import torch
    from video_mamba_suite_torch.ops import (
        LAUNCHES,
        short_scan_bwd,
        short_scan_bwd_ref,
    )

    args = k6_inputs(shape, dtype, seed=sum(shape) + 17, **opts)
    n0 = LAUNCHES["short_scan_bwd"]
    got = short_scan_bwd(**args)
    torch.cuda.synchronize()
    if LAUNCHES["short_scan_bwd"] != n0 + 1:
        raise AssertionError("K6's wrapper did not count its launch")
    want = short_scan_bwd_ref(**args)
    atol, rtol = K6_TOL[dtype]
    names = ("du", "ddelta", "dA", "dB", "dC", "dD", "dz", "ddelta_bias")
    abs_err, rel, worst, ok = 0.0, 0.0, "", True
    for name, g, w in zip(names, got, want):
        if (g is None) != (w is None):
            raise AssertionError(f"K6 at {label}: {name} is {g} against "
                                 f"{w}")
        if g is None:
            continue
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"K6 at {label}: {name} {g.dtype} "
                                 f"{tuple(g.shape)}, want {w.dtype} "
                                 f"{tuple(w.shape)}")
        d = (g.float() - w.float()).abs()
        scale = w.float().abs().max().item()
        bad = d > atol * scale + rtol * w.float().abs()
        if bad.any() or not (torch.isfinite(g).all()
                             and torch.isfinite(w).all()):
            ok = False
            log(f"[k6] {label}: {name} misses at {int(bad.sum())} of "
                f"{g.numel()} (max abs err {d.max().item():.3e}, scale "
                f"{scale:.3e})")
        abs_err = max(abs_err, d.max().item())
        if d.max().item() / max(scale, 1e-30) >= rel:
            rel, worst = d.max().item() / max(scale, 1e-30), name
    log(f"[k6] {label} {shape} {dtype} {opts or ''}: max_abs_err "
        f"{abs_err:.3e}, largest error over scale {rel:.3e} ({worst}) (tol "
        f"atol {atol}·scale, rtol {rtol}) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"K6 disagrees with its plain version at "
                             f"{label} {shape}")
    return args, got, abs_err


def k6_bound_ms(args, grads):
    """Least time for the work and what sets it: each input (the output's
    cotangent included) read once and each gradient written once over HBM,
    against 20 fp32 operations per state update (6 for the forward state
    and y, 14 for the adjoint step's dh, dA, ddt, dB, dC and du terms; an
    exponential counted as one)."""
    import torch

    tensors = [t for t in (*args.values(), *grads)
               if isinstance(t, torch.Tensor)]
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    batch, seqlen, dim = args["u"].shape
    ops = 20.0 * batch * seqlen * dim * args["A"].shape[1]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOP_PER_S
    log(f"[k6] bound: {nbytes / 1e6:.2f} MB over 3.35 TB/s = "
        f"{1e3 * t_bytes:.5f} ms; {ops / 1e9:.4f} GFLOP over 67 TFLOP/s = "
        f"{1e3 * t_ops:.5f} ms")
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else \
        "operations"


def check_k6():
    """Every case of ``K6_CASES``, each with the kernel's time (back to
    back between CUDA events, and its device time alone from the
    profiler), the plain version's (an eager loop and its autograd) and
    the bound; the kernel's registers and spills. The kernel the profiler
    saw run at each case comes from ``check_fresh_routes``. Returns the
    main-path case's (the first) numbers."""
    from video_mamba_suite_torch.ops import short_scan_bwd, short_scan_bwd_ref

    log_resources("short_scan_bwd", "k6")
    result = {}
    for case in K6_CASES:
        args, got, err = k6_check(*case)
        ms = cuda_time_ms(lambda: short_scan_bwd(**args), iters=50)
        device = profile("call", lambda: short_scan_bwd(**args), tag="k6",
                         calls=20, top=0)
        device_ms = source_ms(device, "short_scan_bwd")
        plain_ms = cuda_time_ms(lambda: short_scan_bwd_ref(**args), iters=2,
                                warmup=1)
        bound_ms, bound_by = k6_bound_ms(args, got)
        log(f"[k6] {case[0]}: kernel {ms:.5f} ms per call back to back "
            f"({device_ms:.5f} ms of device time per launch, the partials' "
            f"sums besides), plain {plain_ms:.4f} ms, bound {bound_ms:.5f} "
            f"ms ({bound_by})")
        if not result:
            result = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=None)
    return result


# ---------------------------------------------------------------------------
# K10 and K9: whole-row attention


def attn_inputs(shape, dtype, layout, seed, device="cuda"):
    """Seeded q, k, v of K10 (shape (B, T, H, N, dh): returns the (B, T,
    3H, N, dh) qkv5) or of K9 (shape (I, H, N, dh): returns (q, k, v)) in
    ``layout`` (see ``K10_CASES``, ``K9_CASES``)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    dt = getattr(torch, dtype)

    def randn(*size):
        return torch.randn(*size, device=device, generator=gen).to(dt)

    if len(shape) == 5:
        B, T, H, N, dh = shape
        if layout == "projection":
            return randn(B, N, T, 3 * H * dh).view(
                B, N, T, 3 * H, dh).permute(0, 2, 3, 1, 4)
        return randn(B, T, 3 * H, N, dh)
    I, H, N, dh = shape
    if layout == "projection":
        return tuple(t.reshape(I, N, H, dh).transpose(1, 2)
                     for t in randn(I, N, 3 * H * dh).chunk(3, dim=-1))
    return randn(I, H, N, dh), randn(I, H, N, dh), randn(I, H, N, dh)


def attn_kernel(label):
    """(kernel entry, plain version, LAUNCHES key) of "K10" or "K9"."""
    from video_mamba_suite_torch.ops import (
        row_mha_fwd,
        row_mha_qkv_ref,
        vision_mha_fwd,
        vision_mha_ref,
    )

    if label == "K10":
        return row_mha_fwd, row_mha_qkv_ref, "row_mha_fwd"
    return vision_mha_fwd, vision_mha_ref, "vision_mha_fwd"


def kernel_names(fn, tries=ROUTE_SESSIONS, want=()):
    """Names of the CUDA kernels that one call of ``fn`` launches, from the
    profiler, in a session padded on the host's clock (``padded_profile``:
    the card's timestamps stray from the host's by milliseconds, which
    left unpadded windows short or empty). A session is still repeated,
    up to ``tries`` sessions of the same call, until one records a kernel
    and the sessions together record every kernel named in
    ``want`` (``ROUTE_SESSIONS``); the names of all of them are
    returned."""
    import torch
    from torch.profiler import ProfilerActivity

    from video_mamba_suite_torch.utils.profiler_window import padded_profile

    names = set()
    for _ in range(tries):
        with padded_profile([ProfilerActivity.CUDA]) as prof:
            fn()
        seen = {e.key for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA}
        names |= seen
        if names and all(any(runs(k, n) for n in names) for k in want):
            break
        if not seen:
            time.sleep(0.1)
    return names


def route_names(fn, device, *routes):
    """The kernel names of ``fn``'s profile window ``device`` (kernel name
    → ms), with those of more profiler sessions of ``fn`` where the
    window missed a kernel that ``ROUTES[route]`` names for one of
    ``routes``."""
    want = [k for route in routes for k in ROUTES[route]]
    names = set(device)
    if not all(any(runs(k, n) for n in names) for k in want):
        names |= kernel_names(fn, want=want)
    return names


def runs(kernel_name, profiled):
    """Whether ``profiled`` (a kernel's name in the profiler) is the
    kernel ``kernel_name``: a template instance or a plain function."""
    return re.search(rf"\b{kernel_name}[<(]", profiled) is not None


def route_ms(kernel, dtype, device):
    """The device ms of the kernels ``ROUTES`` gives ``kernel`` at
    ``dtype``, summed from a profile's per-kernel times (nan where the
    profiler's window came back empty)."""
    return sum(ms for key, ms in device.items()
               if any(runs(k, key) for k in ROUTES[(kernel, dtype)])) or \
        float("nan")


def route_split(kernel, dtype, device):
    """Each kernel of ``ROUTES[(kernel, dtype)]`` with its device ms per
    call from a profile (nan where the window missed it)."""
    return [(k, sum(ms for key, ms in device.items() if runs(k, key))
             or float("nan")) for k in ROUTES[(kernel, dtype)]]


def check_route(kernel, label, dtype, names):
    """Raise unless the kernels of ``kernel``'s family (``ROUTE_FAMILIES``)
    among ``names`` (kernel names from the profiler) are exactly the ones
    ``ROUTES`` gives ``kernel`` at ``dtype``."""
    family = next(f for f in ROUTE_FAMILIES if kernel in f)
    known = {k for (entry, _), ks in ROUTES.items() if entry in family
             for k in ks}
    want = sorted(ROUTES[(kernel, dtype)])
    ran = sorted({k for k in known for name in names if runs(k, name)})
    if ran != want:
        raise AssertionError(f"{kernel} at {label} ({dtype}) ran {ran}, "
                             f"want {want}")


# kernels whose registers and spills the build phase reports one by one:
# the tensor-core attention kernels, K1's staged tile kernel and the
# lane-split scans (K3, K2, K4, K7, K8) with K4's and K8's combines
RESOURCE_KERNELS = ("_mma_kernel", "_tile_kernel", "_lanes",
                    "chunked_scan_bwd_combine", "complex_scan_bwd_combine")


def kernel_label(mangled):
    """``name<args>`` of a mangled kernel (template arguments: integers,
    bools, float and bf16), or the mangled name itself."""
    rest, name = mangled[3:] if mangled.startswith("_ZN") else "", None
    while rest[:1].isdigit():     # the nested names, each length-prefixed
        digits = re.match(r"\d+", rest).group(0)
        end = len(digits) + int(digits)
        name, rest = rest[len(digits):end], rest[end:]
    if name is None:
        return mangled
    if not rest.startswith("I"):
        return name
    args = []
    for num, flag, bf16, f32 in re.findall(
            r"Li(\d+)E|Lb([01])E|(13__nv_bfloat16)|(f)",
            rest[1:rest.find("EEv")]):
        args.append(num or ("true" if flag == "1" else "false") if
                    (num or flag) else "bf16" if bf16 else "float")
    return f"{name}<{', '.join(args)}>"


def kernel_resources(build_log):
    """(kernel, registers, spill store bytes, spill load bytes) of each
    kernel named by ``RESOURCE_KERNELS`` in nvcc's ``-Xptxas -v``
    output."""
    found, name, spills = [], None, (0, 0)
    for line in build_log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )(\w+)", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name and any(k in name for k in RESOURCE_KERNELS):
            found.append((kernel_label(name), int(m.group(1)), *spills))
            spills = (0, 0)
    return found


def attn_check(kernel, label, shape, dtype, layout):
    """Launch K10 or K9 (``kernel``) once on the card at one of its cases
    and hold its output against the plain version's (TF32 off). Returns
    (inputs, output, max_abs_err); raises AssertionError on a miss."""
    import torch
    from video_mamba_suite_torch.ops import LAUNCHES

    set_tf32(False)
    fwd, ref, name = attn_kernel(kernel)
    args = attn_inputs(shape, dtype, layout, seed=sum(shape) + 29)
    args = args if isinstance(args, tuple) else (args,)
    n0 = LAUNCHES[name]
    got = fwd(*args)
    torch.cuda.synchronize()
    if LAUNCHES[name] != n0 + 1:
        raise AssertionError(f"{kernel}'s wrapper did not count its launch")
    want = ref(*args)
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{kernel} at {label}: {got.dtype} "
                             f"{tuple(got.shape)}, want {want.dtype} "
                             f"{tuple(want.shape)}")
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    ok = torch.isfinite(got).all().item() and err <= ATTN_TOL[dtype]
    log(f"[{kernel.lower()}] {label} {shape} {dtype} {layout}: max_abs_err "
        f"{err:.3e} at output scale {scale:.3e} (tol {ATTN_TOL[dtype]}) "
        f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"{kernel} disagrees with its plain version at "
                             f"{label} {shape}")
    return args, got, err


def attn_bound_ms(args, out):
    """Least time for the work and what sets it: q, k and v read once and
    the output written once over HBM, against the two products (4·N²·dh
    per instance and head) and the softmax (5·N²: max, subtract, exp, sum,
    divide) at the peak for the inputs' type (bf16 on the tensor cores,
    fp32 outside them)."""
    import torch

    *lead, n, dh = out.shape
    rows = math.prod(lead)
    nbytes = 4 * out.numel() * out.element_size()
    ops = rows * (4.0 * n * n * dh + 5.0 * n * n)
    peak = BF16_TC_FLOP_PER_S if out.dtype == torch.bfloat16 else \
        FP32_FLOP_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    log(f"  bound: {nbytes / 1e6:.2f} MB over 3.35 TB/s = "
        f"{1e3 * t_bytes:.5f} ms; {ops / 1e9:.3f} GFLOP over "
        f"{peak / 1e12:.0f} TFLOP/s = {1e3 * t_ops:.5f} ms")
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else \
        "operations"


def library_attention(args):
    """One PyTorch call that computes the same function: SDPA on the same
    q, k and v (timed only; the port never calls it)."""
    import torch.nn.functional as F
    from video_mamba_suite_torch.ops.vision_attention import _split_heads

    q, k, v = _split_heads(args[0]) if len(args) == 1 else args
    return lambda: F.scaled_dot_product_attention(q, k, v)


def check_attention(kernel, cases):
    """Every case of K10 or K9 (``kernel``), each with the kernel's time
    (back to back between CUDA events, and its device time alone from the
    profiler, whose kernels must be the one ``ROUTES`` names), the plain
    version's, SDPA's and the bound. Returns the main-path case's (the
    first) numbers."""
    fwd, ref, name = attn_kernel(kernel)
    result = {}
    for case in cases:
        args, got, err = attn_check(kernel, *case)
        ms = cuda_time_ms(lambda: fwd(*args), iters=50)
        device = profile("call", lambda: fwd(*args), tag=kernel.lower(),
                         calls=20, top=0)
        check_route(kernel, case[0], case[2],
                    route_names(lambda: fwd(*args), device,
                                (kernel, case[2])))
        device_ms = route_ms(kernel, case[2], device)
        plain_ms = cuda_time_ms(lambda: ref(*args), iters=5, warmup=1)
        library_ms = cuda_time_ms(library_attention(args), iters=50)
        bound_ms, bound_by = attn_bound_ms(args, got)
        log(f"[{kernel.lower()}] {case[0]}: "
            f"{', '.join(ROUTES[(kernel, case[2])])} "
            f"{ms:.5f} ms per call "
            f"back to back ({device_ms:.5f} ms of device time per launch), "
            f"plain {plain_ms:.4f} ms, SDPA {library_ms:.5f} ms, bound "
            f"{bound_ms:.5f} ms ({bound_by})")
        if not result:
            result = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=library_ms)
    return result


# ---------------------------------------------------------------------------
# K11: flash attention, forward and backward


def k11_inputs(shape, dtype, layout, seed, device="cuda"):
    """Seeded q, k, v (B, L, H, dh) of one of ``K11_CASES`` in ``layout``
    ("projection": views of one (B, L, 3·H·dh) projection output, as
    FusedMHA(flash=True) gives them; "contiguous": three tensors;
    "stride4": views of (B, L, H, dh + 4) buffers) and the output's
    cotangent (B, L, H·dh)."""
    import torch

    B, L, H, dh = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    dt = getattr(torch, dtype)

    def randn(*size):
        return torch.randn(*size, device=device, generator=gen).to(dt)

    if layout == "projection":
        q, k, v = (t.view(B, L, H, dh)
                   for t in randn(B, L, 3 * H * dh).chunk(3, dim=-1))
    elif layout == "stride4":
        q, k, v = (randn(B, L, H, dh + 4)[..., :dh] for _ in range(3))
    else:
        q, k, v = (randn(B, L, H, dh) for _ in range(3))
    return q, k, v, randn(B, L, H * dh)


def _max_err(pairs):
    """Largest |got - want| over each pair's scale (its largest |want|, at
    least 1), and the largest absolute difference; raises on a dtype or
    shape mismatch or a value that is not finite on either side."""
    import torch

    rel, absolute = 0.0, 0.0
    for name, got, want in pairs:
        if got.dtype != want.dtype or got.shape != want.shape:
            raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)}, "
                                 f"want {want.dtype} {tuple(want.shape)}")
        for side, t in (("got", got), ("want", want)):
            if not torch.isfinite(t).all():
                raise AssertionError(f"{name}: values that are not finite "
                                     f"({side})")
        d = (got.float() - want.float()).abs().max().item()
        scale = max(1.0, want.float().abs().max().item())
        rel, absolute = max(rel, d / scale), max(absolute, d)
    return rel, absolute


def k11_check(label, shape, causal, dtype, layout):
    """Launch K11's forward and its backward once each on the card at one
    of ``K11_CASES`` (TF32 off) and hold each against its plain version on
    the same inputs (the backward from the kernel's own output and
    log-sum-exp). Returns (inputs, (out, lse), fwd err, bwd err); raises
    AssertionError on a miss."""
    import torch
    from video_mamba_suite_torch.ops import (
        LAUNCHES,
        flash_mha_bwd,
        flash_mha_bwd_ref,
        flash_mha_fwd,
        flash_mha_ref,
    )

    set_tf32(False)
    q, k, v, dout = k11_inputs(shape, dtype, layout, seed=sum(shape) + 31)
    n0 = (LAUNCHES["flash_mha_fwd"], LAUNCHES["flash_mha_bwd"])
    out, lse = flash_mha_fwd(q, k, v, causal)
    grads = flash_mha_bwd(q, k, v, out, lse, dout, causal)
    torch.cuda.synchronize()
    if (LAUNCHES["flash_mha_fwd"], LAUNCHES["flash_mha_bwd"]) != \
            (n0[0] + 1, n0[1] + 1):
        raise AssertionError("K11's wrappers did not count their launches")
    want = flash_mha_ref(q, k, v, causal)
    want_grads = flash_mha_bwd_ref(q, k, v, out, lse, dout, causal)
    out_rel, out_abs = _max_err([("out", out, want[0])])
    lse_rel, lse_abs = _max_err([("lse", lse, want[1])])
    bwd_rel, bwd_abs = _max_err(zip(("dq", "dk", "dv"), grads, want_grads))
    tol, lse_tol = K11_TOL[dtype], K11_TOL["float32"]
    ok = out_rel <= tol and lse_rel <= lse_tol and bwd_rel <= tol
    fwd_abs = max(out_abs, lse_abs)
    log(f"[k11] {label} {shape} {'causal' if causal else 'full'} {dtype} "
        f"{layout}: out max_abs_err {out_abs:.3e} (over scale "
        f"{out_rel:.3e}), lse {lse_abs:.3e} ({lse_rel:.3e}, tol {lse_tol}), "
        f"backward {bwd_abs:.3e} ({bwd_rel:.3e}); tol {tol} of the scale "
        f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"K11 disagrees with its plain version at "
                             f"{label} {shape}")
    return (q, k, v, dout), (out, lse), fwd_abs, bwd_abs


def k11_bound_ms(q, causal, backward):
    """Least time for the work and what sets it: each input read once and
    each output written once over HBM (forward: q, k, v, out and lse;
    backward: q, k, v, out, lse, dout, dq, dk and dv), against the products
    the unmasked (query, key) pairs need (forward 2 of 2·dh, backward 5)
    and 5 (forward) or 8 (backward) softmax operations a pair, at the peak
    for the type (bf16 on the tensor cores, fp32 outside them)."""
    import torch

    B, L, H, dh = q.shape
    pairs = B * H * (L * (L + 1) / 2 if causal else L * L)
    tensors = 8 if backward else 4
    nbytes = tensors * q.numel() * q.element_size() + B * H * L * 4
    ops = pairs * ((10.0 * dh + 8) if backward else (4.0 * dh + 5))
    peak = BF16_TC_FLOP_PER_S if q.dtype == torch.bfloat16 else \
        FP32_FLOP_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    log(f"  bound: {nbytes / 1e6:.2f} MB over 3.35 TB/s = "
        f"{1e3 * t_bytes:.5f} ms; {ops / 1e9:.3f} GFLOP over "
        f"{peak / 1e12:.0f} TFLOP/s = {1e3 * t_ops:.5f} ms")
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else \
        "operations"


def sdpa_calls(q, k, v, dout, causal):
    """SDPA's forward, its forward + backward, and its backward alone (the
    gradients of one saved forward, its graph kept) on the same q, k, v
    and cotangent (timed only; the port never calls it)."""
    import torch
    import torch.nn.functional as F

    B, L, H, dh = q.shape
    heads = [t.transpose(1, 2) for t in (q, k, v)]
    leaves = [t.detach().clone().requires_grad_() for t in heads]
    g = dout.view(B, L, H, dh).transpose(1, 2)

    def fwd():
        return F.scaled_dot_product_attention(*heads, is_causal=causal)

    def fwd_bwd():
        F.scaled_dot_product_attention(*leaves, is_causal=causal).backward(g)

    saved = F.scaled_dot_product_attention(*leaves, is_causal=causal)

    def bwd():
        torch.autograd.grad(saved, leaves, g, retain_graph=True)

    return fwd, fwd_bwd, bwd


def check_k11():
    """Every case of ``K11_CASES``: forward and backward each with its time
    (back to back between CUDA events, and device time from the profiler,
    whose forward and backward kernels must be the ones ``ROUTES`` names),
    SDPA's forward and forward + backward on the same tensors, and the
    bounds; the plain versions timed once, at the first case (the vision
    width). Returns (forward, backward) numbers of the first case."""
    from video_mamba_suite_torch.ops import (
        flash_mha_bwd,
        flash_mha_bwd_ref,
        flash_mha_fwd,
        flash_mha_ref,
    )

    result = ()
    for case in K11_CASES:
        label, _, causal = case[:3]
        (q, k, v, dout), (out, lse), fwd_err, bwd_err = k11_check(*case)
        fwd_ms = cuda_time_ms(lambda: flash_mha_fwd(q, k, v, causal),
                              iters=10)
        bwd_ms = cuda_time_ms(
            lambda: flash_mha_bwd(q, k, v, out, lse, dout, causal), iters=5)
        device = profile("call", lambda: (
            flash_mha_fwd(q, k, v, causal),
            flash_mha_bwd(q, k, v, out, lse, dout, causal)),
            tag="k11", calls=3, top=0)
        names = route_names(lambda: (
            flash_mha_fwd(q, k, v, causal),
            flash_mha_bwd(q, k, v, out, lse, dout, causal)), device,
            ("K11", case[3]), ("K11 bwd", case[3]))
        check_route("K11", label, case[3], names)
        check_route("K11 bwd", label, case[3], names)
        dev_fwd = route_ms("K11", case[3], device)
        dev_bwd = route_ms("K11 bwd", case[3], device)
        sdpa_fwd, sdpa_fwd_bwd, sdpa_bwd = sdpa_calls(q, k, v, dout, causal)
        lib_fwd = cuda_time_ms(sdpa_fwd, iters=10)
        lib_fwd_bwd = cuda_time_ms(sdpa_fwd_bwd, iters=10)
        lib_bwd = cuda_time_ms(sdpa_bwd, iters=10)
        plain_fwd = plain_bwd = float("nan")
        if not result:
            plain_fwd = cuda_time_ms(lambda: flash_mha_ref(q, k, v, causal),
                                     iters=1, warmup=1)
            plain_bwd = cuda_time_ms(lambda: flash_mha_bwd_ref(
                q, k, v, out, lse, dout, causal), iters=1, warmup=1)
        bound_fwd, by_fwd = k11_bound_ms(q, causal, backward=False)
        bound_bwd, by_bwd = k11_bound_ms(q, causal, backward=True)
        log(f"[k11] {label}: forward ({', '.join(ROUTES[('K11', case[3])])}"
            f") {fwd_ms:.4f} ms back to back "
            f"({dev_fwd:.4f} ms device), plain {plain_fwd:.4f} ms, SDPA "
            f"{lib_fwd:.4f} ms, bound {bound_fwd:.5f} ms ({by_fwd}); "
            f"backward ({', '.join(ROUTES[('K11 bwd', case[3])])}) "
            f"{bwd_ms:.4f} ms ({dev_bwd:.4f} ms device), plain "
            f"{plain_bwd:.4f} ms, SDPA backward {lib_bwd:.4f} ms (forward + "
            f"backward {lib_fwd_bwd:.4f} ms), bound {bound_bwd:.5f} ms "
            f"({by_bwd})")
        if not result:
            result = (
                dict(max_abs_err=fwd_err, ms=fwd_ms, plain_ms=plain_fwd,
                     bound_ms=bound_fwd, bound_by=by_fwd, library_ms=lib_fwd),
                dict(max_abs_err=bwd_err, ms=bwd_ms, plain_ms=plain_bwd,
                     bound_ms=bound_bwd, bound_by=by_bwd, library_ms=lib_bwd))
    return result


# ---------------------------------------------------------------------------
# K7 and K8: the complex-A scan and its adjoint


def k7_inputs(shape, dtype, seed, reverse=False, h0=False, groups=0,
              no_dz=False, device="cuda"):
    """Seeded keyword arguments of ``complex_scan_fwd`` at one of
    ``K7_CASES``: A = Ar + i·Ai with Ar in [-1, -0.5) and Ai normal times
    3 (several radians a step); ``dtype`` names the I/O dtype (Ar, Ai, D,
    the bias and the initial state are fp32)."""
    import torch

    batch, seqlen, dim, dstate = shape
    io_dtype = getattr(torch, dtype)
    g = torch.Generator(device=device).manual_seed(seed)

    def normal(*s):
        return torch.randn(*s, device=device, generator=g)

    def unif(*s):
        return torch.rand(*s, device=device, generator=g)

    bc = (batch, seqlen, groups, dstate) if groups else (batch, seqlen,
                                                         dstate)
    return dict(
        u=normal(batch, seqlen, dim).to(io_dtype),
        delta=(0.5 * unif(batch, seqlen, dim)).to(io_dtype),
        Ar=-0.5 - 0.5 * unif(dim, dstate), Ai=3.0 * normal(dim, dstate),
        B=normal(*bc).to(io_dtype), C=normal(*bc).to(io_dtype),
        D=None if no_dz else normal(dim),
        z=None if no_dz else normal(batch, seqlen, dim).to(io_dtype),
        delta_bias=0.5 * unif(dim),
        h0r=normal(batch, dim, dstate) if h0 else None,
        h0i=normal(batch, dim, dstate) if h0 else None,
        delta_softplus=True, reverse=reverse)


def _scan_err(kernel, label, names, got, want, tol):
    """Hold each output within atol · (its largest magnitude) + rtol ·
    |value| of the plain version's (K3's rule); returns the largest
    absolute error; raises AssertionError on a miss."""
    import torch

    atol, rtol = tol
    abs_err, worst, ok = 0.0, 0.0, True
    for name, g, w in zip(names, got, want):
        if g is None and w is None:
            continue
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"{kernel} at {label}: {name} {g.dtype} "
                                 f"{tuple(g.shape)}, want {w.dtype} "
                                 f"{tuple(w.shape)}")
        d = (g.float() - w.float()).abs()
        scale = w.float().abs().max().item()
        bad = d > atol * scale + rtol * w.float().abs()
        if bad.any() or not (torch.isfinite(g).all()
                             and torch.isfinite(w).all()):
            ok = False
            log(f"[{kernel.lower()}] {label}: {name} misses at "
                f"{int(bad.sum())} of {g.numel()} (max abs err "
                f"{d.max().item():.3e}, scale {scale:.3e})")
        abs_err = max(abs_err, d.max().item())
        worst = max(worst, d.max().item() / max(scale, 1e-30))
    log(f"[{kernel.lower()}] {label}: max_abs_err {abs_err:.3e}, largest "
        f"error over scale {worst:.3e} (tol atol {atol}·scale, rtol {rtol}) "
        f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"{kernel} disagrees with its plain version at "
                             f"{label}")
    return abs_err


def k7_check(label, shape, dtype, opts):
    """Launch K7 once (with its checkpoints) on the card at one of
    ``K7_CASES`` and hold its output, last state and checkpoints against
    the plain version's. Returns (inputs, outputs, max_abs_err)."""
    import torch
    from video_mamba_suite_torch.ops import (
        LAUNCHES,
        complex_scan_fwd,
        complex_scan_fwd_ref,
    )
    from video_mamba_suite_torch.ops.selective_scan_complex import (
        CHECKPOINT_STEPS,
    )

    args = k7_inputs(shape, dtype, seed=sum(shape) + 7, **opts)
    n0 = LAUNCHES["complex_scan_fwd"]
    got = complex_scan_fwd(**args, checkpoint_steps=CHECKPOINT_STEPS)
    torch.cuda.synchronize()
    if LAUNCHES["complex_scan_fwd"] != n0 + 1:
        raise AssertionError("K7's wrapper did not count its launch")
    want = complex_scan_fwd_ref(**args, checkpoint_steps=CHECKPOINT_STEPS)
    log(f"[k7] {label} {shape} {dtype} {opts or ''}")
    err = _scan_err("K7", label, ("out", "lastr", "lasti", "statesr",
                                  "statesi"), got, want, K7_TOL[dtype])
    return args, got, err


# special-function results (exp2, sine, cosine) per complex state update:
# K7 one decay (3) a walk; K8 one in the local pass and 1.75 in the main
# pass (its forward walks: 16 + 12 steps a 16-step chunk)
K7_SFU_PER_UPDATE = 3.0
K8_SFU_PER_UPDATE = 3.0 * (1 + 1.75)


def sfu_ms(tag, updates, per_update, what):
    """Log the special-function results of ``updates`` complex state
    updates at ``per_update`` each over the units' rate (``SFU_PER_S``), a
    reading outside the bound."""
    results = updates * per_update
    log(f"[{tag}] special function units: {updates / 1e6:.1f} M complex "
        f"updates x {per_update:g} results ({what}) = {results / 1e6:.1f} M "
        f"over {SFU_PER_S / 1e12:.2f} T/s = {1e3 * results / SFU_PER_S:.4f} "
        f"ms")


def k7_bound_ms(args, outs):
    """Least time for the work and what sets it: each input read once and
    each output written once over HBM, against 20 fp32 operations per
    complex state update (each transcendental counted as one). Also logs
    a third reading, outside the bound: the special-function results of
    one walk over the units' rate."""
    import torch

    tensors = [t for t in (*args.values(), *outs)
               if isinstance(t, torch.Tensor)]
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    batch, seqlen, dim = args["u"].shape
    updates = 1.0 * batch * seqlen * dim * args["Ar"].shape[1]
    ops = 20.0 * updates
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOP_PER_S
    log(f"  bound: {nbytes / 1e6:.1f} MB over 3.35 TB/s = "
        f"{1e3 * t_bytes:.4f} ms; {ops / 1e9:.3f} GFLOP over 67 TFLOP/s = "
        f"{1e3 * t_ops:.4f} ms")
    sfu_ms("k7", updates, K7_SFU_PER_UPDATE, "one walk: exp2, sin, cos")
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else \
        "operations"


def check_k7():
    """Every case of ``K7_CASES`` with the kernel's registers and spills,
    its time (without and with checkpoints) and the bound; the plain
    version timed once, at the first case (the scan microbench shape).
    The kernel the profiler saw run at each case and its device time come
    from ``check_fresh_routes``. Returns the first case's numbers."""
    from video_mamba_suite_torch.ops import (
        complex_scan_fwd,
        complex_scan_fwd_ref,
    )
    from video_mamba_suite_torch.ops.selective_scan_complex import (
        CHECKPOINT_STEPS,
    )

    log_resources("complex_scan_fwd", "k7")
    result = {}
    for case in K7_CASES:
        args, got, err = k7_check(*case)
        ms = cuda_time_ms(lambda: complex_scan_fwd(**args), iters=20)
        ck_ms = cuda_time_ms(lambda: complex_scan_fwd(
            **args, checkpoint_steps=CHECKPOINT_STEPS), iters=20)
        plain_ms = float("nan")
        if not result:     # the plain version always makes checkpoints
            plain_ms = cuda_time_ms(lambda: complex_scan_fwd_ref(**args),
                                    iters=1, warmup=0)
        bound_ms, bound_by = k7_bound_ms(args, got[:3])
        log(f"[k7] {case[0]}: kernel {ms:.4f} ms ({ck_ms:.4f} ms writing "
            f"checkpoints every {CHECKPOINT_STEPS} steps), plain (with "
            f"checkpoints) {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by})")
        if not result:
            result = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=None)
    return result


def fresh_routes(kernels):
    """``check_scan_route`` at every case of ``kernels``' tables (``K5``:
    ``K5_CASES``, ``K6``, ``K7``, ``K8`` likewise, with the inputs of
    ``k5_check``, ``k6_check``, ``k7_check`` and ``k8_check``): the kernels
    the profiler saw run and each one's device ms per call. Raises on a
    miss."""
    from video_mamba_suite_torch.ops import (
        complex_scan_bwd,
        complex_scan_fwd,
        short_scan_bwd,
        short_scan_fwd,
    )

    def k5(shape, dtype, opts):
        args = k5_inputs(shape, dtype, seed=sum(shape) + 3, **opts)
        return lambda: short_scan_fwd(**args)

    def k6(shape, dtype, opts):
        args = k6_inputs(shape, dtype, seed=sum(shape) + 17, **opts)
        return lambda: short_scan_bwd(**args)

    def k7(shape, dtype, opts):
        args = k7_inputs(shape, dtype, seed=sum(shape) + 7, **opts)
        return lambda: complex_scan_fwd(**args)

    def k8(shape, dtype, opts):
        args, states, cot = k8_inputs(shape, dtype, seed=sum(shape) + 8,
                                      **opts)
        del args["h0r"], args["h0i"]
        return lambda: complex_scan_bwd(**args, statesr=states[0],
                                        statesi=states[1], **cot)

    tables = {"K5": (K5_CASES, k5), "K6": (K6_CASES, k6),
              "K7": (K7_CASES, k7), "K8": (K8_CASES, k8)}
    for kernel in kernels:
        cases, call = tables[kernel]
        for label, shape, dtype, opts in cases:
            check_scan_route(kernel, label, dtype, call(shape, dtype, opts),
                             kernel.lower())


def check_fresh_routes(*kernels):
    """``fresh_routes(kernels)`` in a fresh process (``chip_smoke.py
    --routes K5 K6``, say), its log passed on: on an H100's machine, past
    this script's K4 phase (at the parent commit too), most profiler
    sessions of the same process recorded no device activity for calls
    that ran, whatever the padding (up to 1 s), while a fresh process's
    sessions recorded every kernel. Raises unless the child succeeded."""
    import os

    here = os.path.dirname(os.path.abspath(__file__))
    script = os.path.join(here, "chip_smoke.py")
    child = subprocess.run([sys.executable, script, "--routes", *kernels],
                           cwd=here, capture_output=True, text=True,
                           timeout=900)
    for line in child.stdout.splitlines():
        log(line)
    if child.returncode != 0:
        raise AssertionError(f"the {'/'.join(kernels)} route checks failed "
                             f"(rc {child.returncode}):\n"
                             f"{child.stderr[-3000:]}")


def k8_inputs(shape, dtype, seed, **opts):
    """K7's inputs for one of ``K8_CASES`` with K7's checkpoints (from the
    kernel) and seeded cotangents of the output and of the last state's
    two channels."""
    import torch
    from video_mamba_suite_torch.ops import complex_scan_fwd
    from video_mamba_suite_torch.ops.selective_scan_complex import (
        CHECKPOINT_STEPS,
    )

    args = k7_inputs(shape, dtype, seed, **opts)
    _, _, _, statesr, statesi = complex_scan_fwd(
        **args, checkpoint_steps=CHECKPOINT_STEPS)
    device = args["u"].device
    g = torch.Generator(device=device).manual_seed(seed + 1)
    batch, seqlen, dim, dstate = shape
    cot = dict(
        g=torch.randn(batch, seqlen, dim, device=device,
                      generator=g).to(args["u"].dtype),
        glastr=torch.randn(batch, dim, dstate, device=device, generator=g),
        glasti=torch.randn(batch, dim, dstate, device=device, generator=g))
    return args, (statesr, statesi), cot


def k8_check(label, shape, dtype, opts):
    """Launch K8 once on the card at one of ``K8_CASES`` (with cotangents
    of the output and of both last-state channels) and hold its eleven
    gradients against the plain version's. Returns (inputs, checkpoints,
    cotangents, gradients, max_abs_err)."""
    import torch
    from video_mamba_suite_torch.ops import (
        LAUNCHES,
        complex_scan_bwd,
        complex_scan_bwd_ref,
    )
    from video_mamba_suite_torch.ops.selective_scan_complex import GRADS

    args, states, cot = k8_inputs(shape, dtype, seed=sum(shape) + 8, **opts)
    kernel_args = {k: v for k, v in args.items() if k not in ("h0r", "h0i")}
    n0 = LAUNCHES["complex_scan_bwd"]
    got = complex_scan_bwd(**kernel_args, statesr=states[0],
                           statesi=states[1], **cot)
    torch.cuda.synchronize()
    if LAUNCHES["complex_scan_bwd"] != n0 + 1:
        raise AssertionError("K8's wrapper did not count its launch")
    want = complex_scan_bwd_ref(**args, **cot)
    log(f"[k8] {label} {shape} {dtype} {opts or ''}")
    err = _scan_err("K8", label, GRADS, got, want, K8_TOL[dtype])
    return args, states, cot, got, err


def k8_bound_ms(args, states, cot, grads):
    """Least time for the work and what sets it: each input (with K7's
    checkpoints and the cotangents) read once and each gradient written
    once over HBM, against 55 fp32 operations per complex state update
    (20 to recompute the forward, 35 for the adjoint step; each
    transcendental counted as one). Also logs a third reading, outside the
    bound: the special-function results of the three kernels' walks over
    the units' rate."""
    import torch

    tensors = [t for t in (*args.values(), *states, *cot.values(), *grads)
               if isinstance(t, torch.Tensor)]
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    batch, seqlen, dim = args["u"].shape
    updates = 1.0 * batch * seqlen * dim * args["Ar"].shape[1]
    ops = 55.0 * updates
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOP_PER_S
    log(f"  bound: {nbytes / 1e6:.1f} MB over 3.35 TB/s = "
        f"{1e3 * t_bytes:.4f} ms; {ops / 1e9:.3f} GFLOP over 67 TFLOP/s = "
        f"{1e3 * t_ops:.4f} ms")
    sfu_ms("k8", updates, K8_SFU_PER_UPDATE,
           "local 1 decay, main 1.75, 3 each")
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else \
        "operations"


def check_k8():
    """Every case of ``K8_CASES`` with the kernels' registers and spills,
    the time and the bound; the plain version timed once, at the first
    case (the scan microbench shape). The kernels the profiler saw run at
    each case (the local pass, the combine and the main pass) and their
    device times come from ``check_fresh_routes``. Returns the first
    case's numbers."""
    from video_mamba_suite_torch.ops import (
        complex_scan_bwd,
        complex_scan_bwd_ref,
    )

    log_resources("complex_scan_bwd", "k8")
    result = {}
    for case in K8_CASES:
        args, states, cot, grads, err = k8_check(*case)
        kernel_args = {k: v for k, v in args.items()
                       if k not in ("h0r", "h0i")}

        ms = cuda_time_ms(lambda: complex_scan_bwd(
            **kernel_args, statesr=states[0], statesi=states[1], **cot),
            iters=10, warmup=1)
        plain_ms = float("nan")
        if not result:
            plain_ms = cuda_time_ms(
                lambda: complex_scan_bwd_ref(**args, **cot), iters=1,
                warmup=0)
        bound_ms, bound_by = k8_bound_ms(args, states, cot, grads)
        log(f"[k8] {case[0]}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by})")
        if not result:
            result = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=None)
    return result



# ---------------------------------------------------------------------------
# the main paths and the card-vs-CPU checks


def run_main_path():
    import torch
    from video_mamba_suite_torch import build_timemamba_b
    from video_mamba_suite_torch.ops import LAUNCHES, reset_launches

    t0 = time.perf_counter()
    model = build_timemamba_b(device="cuda", dtype=torch.bfloat16, seed=0)
    model.eval()
    log(f"[main] TimeMamba-B built in {time.perf_counter() - t0:.1f} s")
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(BATCH, *clip_shape(), device="cuda",
                    generator=g).to(torch.bfloat16)
    with torch.inference_mode():
        for _ in range(2):                                  # warm-up
            model(x)
        torch.cuda.synchronize()
        reset_launches()
        times = []
        for _ in range(FORWARDS):       # each request ends with its result
            t0 = time.perf_counter()
            out = model(x)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        launches = dict(LAUNCHES)
    if tuple(out.shape) != (BATCH, 512) or not torch.isfinite(out).all():
        raise AssertionError(f"bad output: shape {tuple(out.shape)}, "
                             f"finite {bool(torch.isfinite(out).all())}")
    want = 12 * FORWARDS
    if launches.get("short_bidir_fwd", 0) != want or \
            launches.get("row_mha_fwd") or launches.get("vision_mha_fwd"):
        raise AssertionError(f"K1 launched {launches} times on the main "
                             f"path, want {want} and no K9 or K10")
    times.sort()
    median = statistics.median(times)
    clips = BATCH / median
    flops = model.flops_per_clip()
    mfu = flops * clips / BF16_TC_FLOP_PER_S
    log(f"[main] {FORWARDS} batches of {BATCH} clips: median "
        f"{1e3 * median:.2f} ms/batch (min {1e3 * times[0]:.2f}, max "
        f"{1e3 * times[-1]:.2f}), {clips:.2f} clips/s at the median, "
        f"{flops / 1e9:.1f} GFLOP/clip, MFU {100 * mfu:.2f}% of "
        f"989 TFLOP/s; launches {launches}")
    with torch.inference_mode():
        profile("fwd", lambda: model(x))


def profile(what, fn, tag="profile", calls=2, top=15):
    """Device time over ``calls`` calls of ``fn``: the busy share, the
    ``top`` kernels, and the torch ops that launched them (each op's own
    kernels only, so the op rows do not overlap), in a session padded on
    the host's clock (``padded_profile``; the padding is outside the wall
    time). Returns each kernel's device ms per call, by name."""
    import torch
    from torch.profiler import ProfilerActivity

    from video_mamba_suite_torch.utils.profiler_window import padded_profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with padded_profile(acts) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    stats = prof.key_averages()
    # a range annotated on the device (the optimizer's step) overlaps the
    # kernels it holds, so it is not counted as a kernel
    kernels = [e for e in stats
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
    ops = [e for e in stats
           if e.device_type == torch.autograd.DeviceType.CPU
           and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    log(f"[{tag}] {calls} x {what}: wall {1e3 * wall:.2f} ms, device busy "
        f"{1e3 * busy:.2f} ms ({100 * busy / wall:.1f}%)")
    for kind, events in (("kernel", kernels), ("op", ops)):
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
            log(f"[{tag}] {kind} "
                f"{e.self_device_time_total / (1e3 * calls):9.3f} "
                f"ms/{what} {e.count // calls:5d}x  {e.key[:100]}")
    return {e.key: e.self_device_time_total / (1e3 * calls) for e in kernels}


def run_train_step():
    """The slice's main path: TimeMamba-B train steps on one batch."""
    import torch
    from video_mamba_suite_torch import (
        build_timemamba_b,
        make_optimizer,
        train_step,
    )
    from video_mamba_suite_torch.ops import LAUNCHES, reset_launches

    model = build_timemamba_b(device="cuda", dtype=torch.bfloat16, seed=0)
    opt = make_optimizer(model, "adamw", lr=1e-4, weight_decay=1e-4)
    g = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(BATCH, *clip_shape(), device="cuda",
                    generator=g).to(torch.bfloat16)
    y = torch.randn(BATCH, 512, device="cuda", generator=g)
    losses = [train_step(model, opt, x, y) for _ in range(2)]   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    times = []
    for _ in range(TRAIN_STEPS):     # each step ends with its update done
        t0 = time.perf_counter()
        losses.append(train_step(model, opt, x, y))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    losses = [v.item() for v in losses]
    want = 12 * TRAIN_STEPS
    for name in ("short_bidir_fwd", "short_bidir_bwd"):
        if launches.get(name, 0) != want:
            raise AssertionError(f"{name} launched {launches} times in "
                                 f"{TRAIN_STEPS} train steps, want {want}")
    if launches.get("row_mha_fwd") or launches.get("vision_mha_fwd"):
        raise AssertionError(f"the train steps launched K9 or K10: "
                             f"{launches}")
    if not all(math.isfinite(v) for v in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    times.sort()
    median = statistics.median(times)
    flops = 3 * model.flops_per_clip() * BATCH
    log(f"[train] {TRAIN_STEPS} steps of {BATCH} clips: median "
        f"{1e3 * median:.2f} ms/step (min {1e3 * times[0]:.2f}, max "
        f"{1e3 * times[-1]:.2f}), {BATCH / median:.2f} clips/s, "
        f"{flops / 1e12:.2f} TFLOP/step (3 x forward), MFU "
        f"{100 * flops / median / BF16_TC_FLOP_PER_S:.2f}% of 989 TFLOP/s; "
        f"peak memory {peak / 2**30:.2f} GiB; launches {launches}")
    log(f"[train] loss by step: {' '.join(f'{v:.5f}' for v in losses)}")
    profile("step", lambda: train_step(model, opt, x, y), tag="profile-train")
    return launches


def card_against_cpu():
    import torch
    from video_mamba_suite_torch import build_timemamba_b

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu = build_timemamba_b(device="cpu", dtype=None, seed=1).eval()
    card = copy.deepcopy(cpu).to("cuda")
    g = torch.Generator().manual_seed(1)
    x = torch.randn(1, *clip_shape(), generator=g)
    t0 = time.perf_counter()
    with torch.inference_mode():
        want = cpu(x)
        got = card(x.cuda()).cpu()
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    log(f"[card-vs-cpu] fp32 full width, depth 12, TF32 off: max_abs_err "
        f"{err:.3e} at output scale {scale:.3e} (rel {err / scale:.3e}, "
        f"tol {CARD_CPU_REL_TOL}) in {time.perf_counter() - t0:.1f} s")
    if not torch.isfinite(got).all() or err > CARD_CPU_REL_TOL * scale:
        raise AssertionError("card and CPU forwards disagree")


def card_against_cpu_grads():
    """One clip's loss gradient at full width and depth ``GRAD_DEPTH`` in
    fp32: the card through K1 and K2, the CPU through the plain versions."""
    import torch
    from video_mamba_suite_torch import build_timemamba_b
    from video_mamba_suite_torch.ops import LAUNCHES, reset_launches

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu = build_timemamba_b(device="cpu", dtype=None, seed=3,
                            depth=GRAD_DEPTH)
    card = copy.deepcopy(cpu).to("cuda")
    g = torch.Generator().manual_seed(3)
    x = torch.randn(1, *clip_shape(), generator=g)
    y = torch.randn(1, 512, generator=g)
    t0 = time.perf_counter()
    reset_launches()
    for model, dev in ((cpu, "cpu"), (card, "cuda")):
        model.train()
        loss = torch.mean((model(x.to(dev)) - y.to(dev)) ** 2)
        loss.backward()
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    if launches != {"short_bidir_fwd": GRAD_DEPTH,
                    "short_bidir_bwd": GRAD_DEPTH}:
        raise AssertionError(f"the card's backward launched {launches}")
    worst, worst_name, missing = 0.0, "", []
    cpu_params = dict(cpu.named_parameters())
    for name, p in card.named_parameters():
        want = cpu_params[name].grad
        if p.grad is None or want is None or \
                not torch.isfinite(p.grad).all():
            missing.append(name)
            continue
        rel = ((p.grad.cpu() - want).abs().max()
               / want.abs().max().clamp_min(1e-30)).item()
        if rel >= worst:
            worst, worst_name = rel, name
    log(f"[card-vs-cpu] fp32 gradients, full width, depth {GRAD_DEPTH}, "
        f"TF32 off: largest difference over the CPU gradient's scale "
        f"{worst:.3e} ({worst_name}; tol {CARD_CPU_GRAD_REL_TOL}) over "
        f"{len(cpu_params)} parameters in {time.perf_counter() - t0:.1f} s")
    if missing or worst > CARD_CPU_GRAD_REL_TOL:
        raise AssertionError(f"card and CPU gradients disagree (no or "
                             f"non-finite gradient: {missing})")


@contextlib.contextmanager
def count_plain_calls():
    """Count calls of the scans' and the attention's plain versions (the
    front ends' CPU branches) while the block runs; on the card there
    should be none."""
    # the package's selective_scan function shadows its module's name
    ss = importlib.import_module("video_mamba_suite_torch.ops.selective_scan")
    sb = importlib.import_module(
        "video_mamba_suite_torch.ops.selective_scan_bidir")
    sc = importlib.import_module(
        "video_mamba_suite_torch.ops.selective_scan_chunked")
    sh = importlib.import_module(
        "video_mamba_suite_torch.ops.selective_scan_short")
    va = importlib.import_module(
        "video_mamba_suite_torch.ops.vision_attention")
    calls = collections.Counter()
    patched = [(ss, "selective_scan_ref"), (sb, "selective_scan_bidir_ref"),
               (sc, "chunked_scan_bwd_ref"), (sh, "short_scan_fwd_ref"),
               (sh, "short_scan_bwd_ref"), (va, "row_mha_qkv_ref"),
               (va, "vision_mha_ref")]
    originals = [getattr(mod, name) for mod, name in patched]

    def counting(name, fn):
        def inner(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return inner

    for (mod, name), fn in zip(patched, originals):
        setattr(mod, name, counting(name, fn))
    try:
        yield calls
    finally:
        for (mod, name), fn in zip(patched, originals):
            setattr(mod, name, fn)


@contextlib.contextmanager
def count_checkpoint_writes():
    """Count K3 launches that write checkpoints (for a backward) while the
    block runs."""
    sc = importlib.import_module(
        "video_mamba_suite_torch.ops.selective_scan_chunked")
    calls = collections.Counter()
    launch = sc.chunked_scan_fwd

    def counting(*args):
        if args[-1]:                 # checkpoint_steps
            calls["chunked_scan_fwd with checkpoints"] += 1
        return launch(*args)

    sc.chunked_scan_fwd = counting
    try:
        yield calls
    finally:
        sc.chunked_scan_fwd = launch


def set_tf32(on: bool) -> None:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def vivim_clips(n, seed):
    """n random ViViM-T clips (16 frames, 224², 3 channels) on the card."""
    import torch
    from video_mamba_suite_torch.configs import VIVIM_T_K400

    img = VIVIM_T_K400["img_size"]
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(n, VIVIM_T_K400["num_frames"], img, img, 3,
                       device="cuda", generator=g)


def run_vivim_serving():
    """This slice's main path: ViViM-T K400 recognition serving through
    ``predict``, requests of BATCH clips; then multi-view ``evaluate``."""
    import numpy as np
    import torch
    from video_mamba_suite_torch import (
        build_vivim_tiny_k400,
        evaluate,
        predict,
    )
    from video_mamba_suite_torch.ops import LAUNCHES, reset_launches

    t0 = time.perf_counter()
    model = build_vivim_tiny_k400(device="cuda", seed=0)
    log(f"[vivim] ViViM-T K400 built in {time.perf_counter() - t0:.1f} s")
    x = vivim_clips(BATCH, seed=4)
    set_tf32(True)

    def request():
        probs = predict(model, x)
        torch.cuda.synchronize()      # a request ends with its result
        return probs

    for _ in range(2):                                      # warm-up
        request()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    times = []
    with count_plain_calls() as plain, count_checkpoint_writes() as ck:
        for _ in range(VIVIM_REQUESTS):
            t0 = time.perf_counter()
            probs = request()
            times.append(time.perf_counter() - t0)
    launches = dict(LAUNCHES)
    plain.update(ck)
    peak = torch.cuda.max_memory_allocated()
    if tuple(probs.shape) != (BATCH, 400) or \
            not torch.isfinite(probs).all() or \
            (probs.sum(-1) - 1).abs().max().item() > 1e-4:
        raise AssertionError(f"bad class probabilities: shape "
                             f"{tuple(probs.shape)}")
    want = {"chunked_scan_fwd": VIVIM_LAUNCHES * VIVIM_REQUESTS}
    if launches != want or sum(plain.values()):
        raise AssertionError(f"ViViM-T serving launched {launches} (want "
                             f"{want}) and called plain versions "
                             f"{dict(plain)}")
    times.sort()
    median = statistics.median(times)
    clips = BATCH / median
    flops = model.flops_per_clip()
    mfu = flops * clips / TF32_TC_FLOP_PER_S
    log(f"[vivim] TF32 on (matmul {torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn {torch.backends.cudnn.allow_tf32}): {VIVIM_REQUESTS} "
        f"requests of {BATCH} clips: median {1e3 * median:.2f} ms/request "
        f"(min {1e3 * times[0]:.2f}, max {1e3 * times[-1]:.2f}), "
        f"{clips:.2f} clips/s at the median, {flops / 1e9:.2f} GFLOP/clip, "
        f"MFU {100 * mfu:.3f}% of 495 TFLOP/s (TF32 dense); peak memory "
        f"{peak / 2**30:.2f} GiB; launches {launches}, plain-version calls "
        f"{dict(plain)}")
    profile("request", request, tag="profile-vivim")

    set_tf32(False)
    request()
    off = []
    for _ in range(5):
        t0 = time.perf_counter()
        request()
        off.append(time.perf_counter() - t0)
    log(f"[vivim] TF32 off: median {1e3 * statistics.median(off):.2f} "
        f"ms/request over 5 (min {1e3 * min(off):.2f}, max "
        f"{1e3 * max(off):.2f})")
    set_tf32(True)

    views = 12
    videos = vivim_clips(2 * views, seed=5)
    labels = np.repeat(np.array([17, 301]), views)
    video_ids = np.repeat(np.arange(2), views)
    reset_launches()
    t0 = time.perf_counter()
    acc = evaluate(model, videos, labels, video_ids, batch_size=BATCH)
    torch.cuda.synchronize()
    n = LAUNCHES["chunked_scan_fwd"]
    log(f"[vivim] evaluate: 2 videos x {views} views in "
        f"{-(-2 * views // BATCH)} requests, {time.perf_counter() - t0:.2f}"
        f" s: {acc} (random weights); K3 launches {n}")
    if n != VIVIM_LAUNCHES * -(-2 * views // BATCH) or \
            set(acc) != {"top1", "top5"} or \
            not all(0.0 <= v <= 100.0 for v in acc.values()):
        raise AssertionError(f"evaluate: {acc}, {n} K3 launches")
    return launches


def run_vivim_finetune():
    """This slice's main path: ViViM-T K400 finetune steps through
    ``RecognitionTrainer.train_step`` at the preset's values."""
    import torch
    from video_mamba_suite_torch import build_vivim_k400_trainer
    from video_mamba_suite_torch.ops import LAUNCHES, reset_launches

    t0 = time.perf_counter()
    trainer = build_vivim_k400_trainer(device="cuda", seed=0)
    model = trainer.model
    opt = type(trainer.optimizer).__name__
    log(f"[finetune] ViViM-T K400 trainer built in "
        f"{time.perf_counter() - t0:.1f} s: {opt}, "
        f"{len(set(trainer.grad_scales.values()))} layer-decay factors, "
        f"learning rate {trainer.schedule(0):.3g} at step 0, "
        f"{trainer.schedule(1):.3g} at 1, {trainer.schedule(100):.3g} at "
        f"100")
    set_tf32(True)
    x = vivim_clips(BATCH, seed=7)
    labels = torch.randint(400, (BATCH,), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(7))

    def snapshot():
        return ({n: p.detach().clone() for n, p in model.named_parameters()},
                {n: e.clone() for n, e in trainer.ema.state_dict().items()})

    params0, ema0 = snapshot()
    losses = [trainer.train_step(x, labels)]     # warm-up 1: rate 0
    bad = [n for n, p in model.named_parameters()
           if p.grad is None or not torch.isfinite(p.grad).all()]
    zero = [n for n, p in model.named_parameters()
            if p.grad is not None and not p.grad.abs().sum()]
    moved = [n for n, p in model.named_parameters()
             if not torch.equal(p, params0[n])]
    if bad or moved:
        raise AssertionError(f"step 0: no or non-finite gradient at {bad}; "
                             f"moved at rate 0: {moved}")
    params1, ema1 = snapshot()
    losses.append(trainer.train_step(x, labels))  # warm-up 2
    still = [n for n, p in model.named_parameters()
             if n not in zero and torch.equal(p, params1[n])]
    ema = trainer.ema.state_dict()
    closer = sum((ema[n] - p).abs().sum().item()
                 for n, p in model.named_parameters()) < \
        sum((ema1[n] - p).abs().sum().item()
            for n, p in model.named_parameters())
    if still or not closer:
        raise AssertionError(f"step 1 left {still} unmoved (EMA moved "
                             f"towards the parameters: {closer})")
    log(f"[finetune] warm-up: every one of {len(params0)} parameters has a "
        f"finite gradient ({len(zero)} all zero: {zero}); rate 0 moved none; "
        f"the second step moved all with a gradient and the EMA towards "
        f"them; losses {losses[0]:.5f} {losses[1]:.5f}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    times = []
    with count_plain_calls() as plain, count_checkpoint_writes() as ck:
        for _ in range(FINETUNE_STEPS):   # a step ends with its loss read
            t0 = time.perf_counter()
            losses.append(trainer.train_step(x, labels))
            times.append(time.perf_counter() - t0)
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    want = {"chunked_scan_fwd": VIVIM_LAUNCHES * FINETUNE_STEPS,
            "chunked_scan_bwd": VIVIM_LAUNCHES * FINETUNE_STEPS}
    if launches != want or sum(plain.values()) or \
            ck["chunked_scan_fwd with checkpoints"] != want[
                "chunked_scan_fwd"]:
        raise AssertionError(f"finetune launched {launches} (want {want}), "
                             f"plain-version calls {dict(plain)}, "
                             f"checkpoint writes {dict(ck)}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    times.sort()
    median = statistics.median(times)
    flops = 3 * model.flops_per_clip() * BATCH
    log(f"[finetune] {FINETUNE_STEPS} steps of {BATCH} clips: median "
        f"{1e3 * median:.2f} ms/step (min {1e3 * times[0]:.2f}, max "
        f"{1e3 * times[-1]:.2f}), {BATCH / median:.2f} clips/s, "
        f"{flops / 1e12:.3f} TFLOP/step (3 x forward), MFU "
        f"{100 * flops / median / TF32_TC_FLOP_PER_S:.3f}% of 495 TFLOP/s "
        f"(TF32 dense); peak memory {peak / 2**30:.2f} GiB; launches "
        f"{launches}, K3 with checkpoints {dict(ck)}, plain-version calls "
        f"{dict(plain)}")
    log(f"[finetune] loss by step: {' '.join(f'{v:.5f}' for v in losses)}")
    profile("step", lambda: trainer.train_step(x, labels),
            tag="profile-finetune")
    return launches


def card_against_cpu_vivim_grads():
    """One clip's soft-target cross-entropy gradient, ViViM-T at full
    width and depth ``GRAD_DEPTH``, fp32, TF32 off, drop-path 0, no mixup:
    the card through K3 and K4 (batch 1, the TPU package's batch <= 4
    form) against the CPU through the plain versions."""
    import torch
    from video_mamba_suite_torch import build_vivim_tiny_k400
    from video_mamba_suite_torch.ops import LAUNCHES, reset_launches
    from video_mamba_suite_torch.tasks.recognition import (
        one_hot_smooth,
        soft_target_cross_entropy,
    )

    set_tf32(False)
    cpu = build_vivim_tiny_k400(device="cpu", seed=2, depth=GRAD_DEPTH,
                                drop_path_rate=0.0)
    card = copy.deepcopy(cpu).to("cuda")
    x = vivim_clips(1, seed=8)
    targets = one_hot_smooth(torch.tensor([123]), 400, 0.1)
    t0 = time.perf_counter()
    reset_launches()
    for model, dev in ((cpu, "cpu"), (card, "cuda")):
        model.train()
        soft_target_cross_entropy(model(x.to(dev)),
                                  targets.to(dev)).backward()
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    want = {"chunked_scan_fwd": 2 * GRAD_DEPTH,
            "chunked_scan_bwd": 2 * GRAD_DEPTH}
    if launches != want:
        raise AssertionError(f"the card's backward launched {launches}")
    worst, worst_name, missing = 0.0, "", []
    cpu_params = dict(cpu.named_parameters())
    for name, p in card.named_parameters():
        ref = cpu_params[name].grad
        if p.grad is None or ref is None or \
                not torch.isfinite(p.grad).all():
            missing.append(name)
            continue
        rel = ((p.grad.cpu() - ref).abs().max()
               / ref.abs().max().clamp_min(1e-30)).item()
        if rel >= worst:
            worst, worst_name = rel, name
    log(f"[card-vs-cpu] ViViM-T fp32 gradients, full width, depth "
        f"{GRAD_DEPTH}, batch 1, TF32 off: largest difference over the CPU "
        f"gradient's scale {worst:.3e} ({worst_name}; tol "
        f"{CARD_CPU_VIVIM_GRAD_REL_TOL}) over {len(cpu_params)} parameters "
        f"in {time.perf_counter() - t0:.1f} s")
    if missing or worst > CARD_CPU_VIVIM_GRAD_REL_TOL:
        raise AssertionError(f"card and CPU ViViM-T gradients disagree (no "
                             f"or non-finite gradient: {missing})")


def card_against_cpu_vivim():
    """One clip of ViViM-T at full width and depth, fp32, TF32 off: the
    card through K3 against the CPU through the plain versions."""
    import torch
    from video_mamba_suite_torch import build_vivim_tiny_k400
    from video_mamba_suite_torch.ops import LAUNCHES, reset_launches

    set_tf32(False)
    cpu = build_vivim_tiny_k400(device="cpu", seed=1).eval()
    card = copy.deepcopy(cpu).to("cuda")
    x = vivim_clips(1, seed=6)
    t0 = time.perf_counter()
    reset_launches()
    with torch.inference_mode():
        got = card(x).cpu()
        want = cpu(x.cpu())
    launches = dict(LAUNCHES)
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    log(f"[card-vs-cpu] ViViM-T fp32 full width, depth 24, TF32 off: "
        f"max_abs_err {err:.3e} at output scale {scale:.3e} (rel "
        f"{err / scale:.3e}, tol {CARD_CPU_VIVIM_REL_TOL}) in "
        f"{time.perf_counter() - t0:.1f} s; card launches {launches}")
    if launches != {"chunked_scan_fwd": VIVIM_LAUNCHES} or \
            not torch.isfinite(got).all() or \
            err > CARD_CPU_VIVIM_REL_TOL * scale:
        raise AssertionError("card and CPU ViViM-T forwards disagree")


def lm_prompt(model, batch, length, seed, device="cuda"):
    """Random prompt ids (batch, length) below the model's vocabulary."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(model.vocab_size, (batch, length), device=device,
                         generator=g)


def run_lm_serving():
    """This slice's main path: Mamba-130M serving through ``generate``
    (batch 8, prompt 16, 128 new tokens, greedy, bf16 weights): the
    batched prefill runs K5 in every layer, the decode steps plain torch."""
    import torch
    from video_mamba_suite_torch import (
        GenerationConfig,
        build_mamba_lm,
        generate,
    )
    from video_mamba_suite_torch.configs import MAMBA_130M
    from video_mamba_suite_torch.ops import LAUNCHES, reset_launches

    t0 = time.perf_counter()
    model = build_mamba_lm(MAMBA_130M, dtype=torch.bfloat16, seed=0)
    n_layer = model.n_layer
    log(f"[lm] Mamba-130M built in {time.perf_counter() - t0:.1f} s: "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.2f} M "
        f"parameters, {n_layer} layers, vocabulary {model.padded_vocab}, "
        f"bf16")
    ids = lm_prompt(model, LM_BATCH, LM_PROMPT, seed=9)
    config = GenerationConfig(max_length=LM_PROMPT + LM_NEW)

    def request():
        out = generate(model, ids, config)
        torch.cuda.synchronize()      # a request ends with its tokens
        return out

    first = request()                                     # warm-up
    request()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    times = []
    with count_plain_calls() as plain, count_checkpoint_writes() as ck:
        for _ in range(LM_REQUESTS):
            t0 = time.perf_counter()
            out = request()
            times.append(time.perf_counter() - t0)
    launches = dict(LAUNCHES)
    plain.update(ck)
    peak = torch.cuda.max_memory_allocated()
    if tuple(out.shape) != (LM_BATCH, LM_PROMPT + LM_NEW) or \
            not torch.equal(out[:, :LM_PROMPT], ids) or \
            not torch.equal(out, first) or \
            not ((out >= 0) & (out < model.padded_vocab)).all():
        raise AssertionError(f"bad generated ids: shape {tuple(out.shape)}, "
                             f"the same as the warm-up's: "
                             f"{torch.equal(out, first)}")
    want = {"short_scan_fwd": n_layer * LM_REQUESTS}
    if launches != want or sum(plain.values()):
        raise AssertionError(f"Mamba-130M serving launched {launches} (want "
                             f"{want}) and called plain versions "
                             f"{dict(plain)}")
    times.sort()
    median = statistics.median(times)

    with torch.inference_mode():
        logits, states = model.prefill(ids)
        if not torch.isfinite(logits).all():
            raise AssertionError("non-finite prefill logits")
        prefill_ms = statistics.median(
            cuda_time_ms(lambda: model.prefill(ids), iters=5, warmup=1)
            for _ in range(3))
        token = logits.argmax(-1)

        def steps(n=20):
            nonlocal token, states
            for _ in range(n):
                logits, states = model.step(token, states)
                token = logits.argmax(-1)

        step_ms = cuda_time_ms(steps, iters=3, warmup=1) / 20
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    state_bytes = sum(t.numel() * t.element_size() for st in states
                      for t in st)
    step_bytes = weight_bytes + 2 * state_bytes   # states read and written
    share = step_bytes / HBM_BYTES_PER_S / (step_ms / 1e3)
    log(f"[lm] {LM_REQUESTS} requests of {LM_BATCH} x ({LM_PROMPT} prompt "
        f"+ {LM_NEW} new) tokens, greedy: median {1e3 * median:.2f} "
        f"ms/request (min {1e3 * times[0]:.2f}, max {1e3 * times[-1]:.2f}); "
        f"{LM_BATCH * LM_NEW / median:.1f} generated tok/s, "
        f"{LM_BATCH * (LM_PROMPT + LM_NEW) / median:.1f} tok/s as bench.py "
        f"counts (prompt + generated); prefill {prefill_ms:.3f} ms, decode "
        f"step {step_ms:.3f} ms; a step moves {step_bytes / 1e6:.1f} MB "
        f"(bf16 weights {weight_bytes / 1e6:.1f} MB + states read and "
        f"written), {100 * share:.2f}% of 3.35 TB/s; peak memory "
        f"{peak / 2**30:.2f} GiB; launches {launches}, plain-version calls "
        f"{dict(plain)}")

    long_ids = lm_prompt(model, LM_BATCH, LM_LONG_PROMPT, seed=10)
    reset_launches()
    with count_plain_calls() as plain, count_checkpoint_writes() as ck, \
            torch.inference_mode():
        logits, _ = model.prefill(long_ids)
        torch.cuda.synchronize()
    long_launches = dict(LAUNCHES)
    plain.update(ck)
    log(f"[lm] prefill at prompt {LM_LONG_PROMPT}: launches "
        f"{long_launches}, plain-version calls and checkpoint writes "
        f"{dict(plain)}")
    if long_launches != {"chunked_scan_fwd": n_layer} or \
            sum(plain.values()) or not torch.isfinite(logits).all():
        raise AssertionError(f"the prompt of {LM_LONG_PROMPT} launched "
                             f"{long_launches} (want {n_layer} K3 and no K5)")
    short = GenerationConfig(max_length=LM_PROMPT + LM_PROFILE_NEW)
    with torch.inference_mode():
        profile(f"request of {LM_PROFILE_NEW} new tokens",
                lambda: generate(model, ids, short), tag="profile-lm",
                calls=1)
    return launches


def card_against_cpu_lm():
    """Mamba-130M at full width and depth, fp32, TF32 off, batch 2: the
    card through K5 (prompt 16) and K3 (prompt 80) against the CPU through
    the plain versions; the prefill logits, every layer's (conv_state,
    ssm_state), then the logits of decode steps fed the same tokens."""
    import torch
    from video_mamba_suite_torch import build_mamba_lm
    from video_mamba_suite_torch.configs import MAMBA_130M
    from video_mamba_suite_torch.ops import LAUNCHES, reset_launches

    set_tf32(False)
    cpu = build_mamba_lm(MAMBA_130M, device="cpu", seed=1)
    card = copy.deepcopy(cpu).to("cuda")
    t0 = time.perf_counter()

    def rel(got, want):
        return ((got.cpu() - want).abs().max()
                / want.abs().max().clamp_min(1e-30)).item()

    worst = {}
    for prompt, kernel in ((LM_PROMPT, "short_scan_fwd"),
                           (80, "chunked_scan_fwd")):
        ids = lm_prompt(cpu, 2, prompt, seed=prompt, device="cpu")
        feed = lm_prompt(cpu, 2, CARD_CPU_LM_STEPS, seed=prompt + 1,
                         device="cpu")
        reset_launches()
        with torch.inference_mode():
            want, want_states = cpu.prefill(ids)
            got, states = card.prefill(ids.cuda())
            torch.cuda.synchronize()
            launches = dict(LAUNCHES)
            errs = {"prefill logits": rel(got, want)}
            errs["conv states"] = max(rel(g[0], w[0]) for g, w in
                                      zip(states, want_states))
            errs["ssm states"] = max(rel(g[1], w[1]) for g, w in
                                     zip(states, want_states))
            step_err = 0.0
            for t in range(CARD_CPU_LM_STEPS):
                want, want_states = cpu.step(feed[:, t], want_states)
                got, states = card.step(feed[:, t].cuda(), states)
                step_err = max(step_err, rel(got, want))
            errs["decode logits"] = step_err
        log(f"[card-vs-cpu] Mamba-130M fp32, depth {cpu.n_layer}, batch 2, "
            f"TF32 off, prompt {prompt} ({kernel}): largest difference "
            f"over each tensor's scale: "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
            + f" ({CARD_CPU_LM_STEPS} decode steps; tol "
            f"{CARD_CPU_LM_REL_TOL}); card launches {launches}")
        if launches != {kernel: cpu.n_layer}:
            raise AssertionError(f"the card's prefill at {prompt} launched "
                                 f"{launches}")
        for k, v in errs.items():
            worst[f"{k} at {prompt}"] = v
    log(f"[card-vs-cpu] Mamba-130M done in {time.perf_counter() - t0:.1f} s")
    if not all(math.isfinite(v) and v <= CARD_CPU_LM_REL_TOL
               for v in worst.values()):
        raise AssertionError(f"card and CPU Mamba-130M disagree: {worst}")


# ---------------------------------------------------------------------------
# action anticipation: LSTR-Mamba at the EK100 preset's widths


def ant_batch(config, batch, seed, device="cuda"):
    """Random (visual, motion) features for a configuration's long + work
    frames and int targets for its work + anticipation positions."""
    import torch

    cfg = config["model"]
    frames = cfg["long_memory_num_samples"] + cfg["work_memory_num_samples"]
    positions = (cfg["work_memory_num_samples"]
                 + cfg["anticipation_num_samples"])
    g = torch.Generator(device=device).manual_seed(seed)
    visual = torch.randn(batch, frames, cfg["visual_dim"], device=device,
                         generator=g)
    motion = torch.randn(batch, frames, cfg["motion_dim"], device=device,
                         generator=g)
    targets = torch.randint(cfg["num_classes"], (batch, positions),
                            device=device, generator=g)
    return visual, motion, targets


def ant_configs():
    """(label, configuration, the scan kernels of its forward)."""
    from video_mamba_suite_torch.configs import (
        ANTICIPATION_EK100,
        ANTICIPATION_EK100_SHORT,
    )

    return (("preset", ANTICIPATION_EK100, "chunked_scan_fwd"),
            ("short", ANTICIPATION_EK100_SHORT, "short_scan_fwd"))


def run_anticipation_serving():
    """This slice's serving path: LSTR-Mamba (EK100 widths, random weights
    from a seed, fp32 with TF32 matmuls) answers requests of the preset's
    batch (16 windows) through ``predict``: the preset's 548 tokens take K3
    (one per layer, no checkpoints), the short configuration's 64 take K5.
    Returns the short model for the streaming phase."""
    import torch
    from video_mamba_suite_torch import LSTRMamba
    from video_mamba_suite_torch.ops import LAUNCHES, reset_launches
    from video_mamba_suite_torch.tasks.anticipation import predict

    set_tf32(True)
    for label, config, kernel in ant_configs():
        model = LSTRMamba(**config["model"],
                          generator=torch.Generator().manual_seed(0))
        batch = config["batch_size"]
        visual, motion, targets = ant_batch(config, batch, seed=12)

        def request():
            probs = predict(model, visual, motion)
            torch.cuda.synchronize()      # a request ends with its result
            return probs

        for _ in range(2):                                  # warm-up
            request()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        times = []
        with count_plain_calls() as plain, count_checkpoint_writes() as ck:
            for _ in range(ANT_REQUESTS):
                t0 = time.perf_counter()
                probs = request()
                times.append(time.perf_counter() - t0)
        launches = dict(LAUNCHES)
        plain.update(ck)
        peak = torch.cuda.max_memory_allocated()
        want_shape = (*targets.shape, config["model"]["num_classes"])
        if tuple(probs.shape) != want_shape or \
                not torch.isfinite(probs).all() or \
                (probs.sum(-1) - 1).abs().max().item() > 1e-4:
            raise AssertionError(f"bad anticipation scores: shape "
                                 f"{tuple(probs.shape)}, want {want_shape}")
        want = {kernel: ANT_LAYERS * ANT_REQUESTS}
        if launches != want or sum(plain.values()):
            raise AssertionError(f"anticipation serving ({label}) launched "
                                 f"{launches} (want {want}) and called "
                                 f"plain versions {dict(plain)}")
        times.sort()
        median = statistics.median(times)
        tokens = visual.shape[1] + config["model"]["anticipation_num_samples"]
        log(f"[ant-serve] {label}: {ANT_REQUESTS} requests of {batch} "
            f"windows x {visual.shape[1]} frames "
            f"({tokens} tokens), fp32 + TF32: median {1e3 * median:.3f} "
            f"ms/request "
            f"(min {1e3 * times[0]:.3f}, max {1e3 * times[-1]:.3f}), "
            f"{batch / median:.1f} windows/s; peak memory "
            f"{peak / 2**30:.2f} GiB; launches {launches}, plain-version "
            f"calls {dict(plain)}")
        profile("request", request, tag=f"profile-ant-serve-{label}")
    return model


def run_anticipation_streaming(model):
    """Streaming on the short model: ``stream_prefill`` over an
    ANT_HISTORY-frame history (one K5 per layer), then ANT_STREAM_STEPS
    ``stream_step`` calls, plain torch (no kernel)."""
    import torch
    from video_mamba_suite_torch.configs import ANTICIPATION_EK100_SHORT
    from video_mamba_suite_torch.models import sinusoid_positions
    from video_mamba_suite_torch.ops import LAUNCHES, reset_launches

    cfg = ANTICIPATION_EK100_SHORT["model"]
    batch = ANTICIPATION_EK100_SHORT["batch_size"]
    g = torch.Generator(device="cuda").manual_seed(13)
    frames = ANT_HISTORY + ANT_STREAM_STEPS
    visual = torch.randn(batch, frames, cfg["visual_dim"], device="cuda",
                         generator=g)
    motion = torch.randn(batch, frames, cfg["motion_dim"], device="cuda",
                         generator=g)
    pe = sinusoid_positions(frames, cfg["d_model"], device="cuda")
    with torch.inference_mode(), count_plain_calls() as plain:
        model.eval()
        toks = model.embed_work_token(visual, motion) + pe
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        scores, states = model.stream_prefill(toks[:, :ANT_HISTORY])
        torch.cuda.synchronize()
        prefill_ms = 1e3 * (time.perf_counter() - t0)
        prefill_launches = dict(LAUNCHES)
        reset_launches()
        logits, _ = model.stream_step(toks[:, ANT_HISTORY], states)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(ANT_HISTORY, frames):
            logits, states = model.stream_step(toks[:, t], states)
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0) / ANT_STREAM_STEPS
        step_launches = dict(LAUNCHES)
    if prefill_launches != {"short_scan_fwd": ANT_LAYERS} or \
            step_launches or sum(plain.values()):
        raise AssertionError(f"streaming launched {prefill_launches} in the "
                             f"prefill and {step_launches} in the steps; "
                             f"plain-version calls {dict(plain)}")
    if not (torch.isfinite(scores).all() and torch.isfinite(logits).all()):
        raise AssertionError("non-finite streaming scores")
    log(f"[ant-stream] stream_prefill over {ANT_HISTORY} frames x "
        f"{batch} streams: {prefill_ms:.3f} ms (launches "
        f"{prefill_launches}); then {ANT_STREAM_STEPS} stream_step calls: "
        f"{step_ms:.3f} ms per step (host clock, synchronised at the end), "
        f"launches {step_launches}")


def run_anticipation_train():
    """This slice's train path: ``AnticipationTrainer.train_step`` at the
    preset's recipe (AdamW lr 7e-5, weight decay 5e-5, warmup-cosine,
    classifier dropout 0.2, batch 16), fp32 with TF32 matmuls. The
    preset's step launches K3 (writing checkpoints) and K4 per layer, the
    short configuration's K5 and K6. Returns the short step's launches."""
    import torch
    from video_mamba_suite_torch import build_anticipation_trainer
    from video_mamba_suite_torch.ops import LAUNCHES, reset_launches

    set_tf32(True)
    kernels = {"chunked_scan_fwd": ("chunked_scan_fwd", "chunked_scan_bwd"),
               "short_scan_fwd": ("short_scan_fwd", "short_scan_bwd")}
    for label, config, kernel in ant_configs():
        trainer = build_anticipation_trainer(config, seed=0)
        model = trainer.model
        batch = config["batch_size"]
        visual, motion, targets = ant_batch(config, batch, seed=14)
        losses = [trainer.train_step(visual, motion, targets)]  # warm-up
        bad = [n for n, p in model.named_parameters()
               if p.grad is None or not torch.isfinite(p.grad).all()]
        if bad:
            raise AssertionError(f"{label}: no or non-finite gradient at "
                                 f"{bad}")
        losses.append(trainer.train_step(visual, motion, targets))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        times = []
        with count_plain_calls() as plain, count_checkpoint_writes() as ck:
            for _ in range(ANT_STEPS):    # a step ends with its loss read
                t0 = time.perf_counter()
                losses.append(trainer.train_step(visual, motion, targets))
                times.append(time.perf_counter() - t0)
        launches = dict(LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        want = {k: ANT_LAYERS * ANT_STEPS for k in kernels[kernel]}
        writes = ck["chunked_scan_fwd with checkpoints"]
        if launches != want or sum(plain.values()) or \
                writes != want.get("chunked_scan_fwd", 0):
            raise AssertionError(f"{label} train steps launched {launches} "
                                 f"(want {want}), plain-version calls "
                                 f"{dict(plain)}, checkpoint writes {writes}")
        if not all(math.isfinite(v) for v in losses) or \
                not losses[-1] < losses[0]:
            raise AssertionError(f"{label}: the loss did not fall: {losses}")
        times.sort()
        median = statistics.median(times)
        log(f"[ant-train] {label}: {ANT_STEPS} steps of {batch} windows "
            f"x {visual.shape[1]} frames, fp32 + TF32: median "
            f"{1e3 * median:.3f} ms/step (min {1e3 * times[0]:.3f}, max "
            f"{1e3 * times[-1]:.3f}), {batch / median:.1f} windows/s; "
            f"peak memory {peak / 2**30:.2f} GiB; launches {launches}, "
            f"checkpoint writes {writes}, plain-version calls "
            f"{dict(plain)}; every one of "
            f"{len(list(model.parameters()))} parameters had a finite "
            f"gradient")
        log(f"[ant-train] {label} loss by step: "
            f"{' '.join(f'{v:.5f}' for v in losses)}")
        profile("step", lambda: trainer.train_step(visual, motion, targets),
                tag=f"profile-ant-train-{label}")
    return launches


def card_against_cpu_anticipation():
    """LSTR-Mamba at full width and depth 2, fp32, TF32 off: the card
    through the kernels against the CPU through the plain versions. The
    short configuration at batch 2 (K5, K6): forward scores, the states of
    ``stream_prefill``, and every parameter's gradient after one backward
    (classifier dropout off); the preset at batch 1 (K3): forward
    scores."""
    import torch
    from video_mamba_suite_torch import LSTRMamba
    from video_mamba_suite_torch.ops import LAUNCHES, reset_launches
    from video_mamba_suite_torch.tasks.anticipation import anticipation_loss

    set_tf32(False)
    t0 = time.perf_counter()

    def rel(got, want):
        return ((got.detach().cpu() - want).abs().max()
                / want.abs().max().clamp_min(1e-30)).item()

    errs, grad_err, grad_name, missing = {}, 0.0, "", []
    for (label, config, kernel), batch in zip(ant_configs(), (1, 2)):
        cpu = LSTRMamba(**dict(config["model"], dropout_cls=0.0),
                        device="cpu",
                        generator=torch.Generator().manual_seed(1))
        card = copy.deepcopy(cpu).to("cuda")
        visual, motion, targets = ant_batch(config, batch, seed=15,
                                            device="cpu")
        reset_launches()
        with torch.inference_mode():
            want = cpu.eval()(visual, motion)["score"]
            got = card.eval()(visual.cuda(), motion.cuda())["score"]
            torch.cuda.synchronize()
            errs[f"{label} scores"] = rel(got, want)
            if label == "short":
                toks = cpu.embed_work_token(visual, motion)
                _, want_states = cpu.stream_prefill(toks)
                _, states = card.stream_prefill(toks.cuda())
                errs["short conv states"] = max(
                    rel(g[0], w[0]) for g, w in zip(states, want_states))
                errs["short ssm states"] = max(
                    rel(g[1], w[1]) for g, w in zip(states, want_states))
        launches = dict(LAUNCHES)
        if launches != {kernel: (1 + (label == "short")) * ANT_LAYERS}:
            raise AssertionError(f"{label}: the card's forwards launched "
                                 f"{launches}")
        if label != "short":
            continue
        reset_launches()
        for model, dev in ((cpu, "cpu"), (card, "cuda")):
            model.train()
            out = model(visual.to(dev), motion.to(dev))["score"]
            anticipation_loss(out, targets.to(dev)).backward()
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
        if launches != {"short_scan_fwd": ANT_LAYERS,
                        "short_scan_bwd": ANT_LAYERS}:
            raise AssertionError(f"the card's backward launched {launches}")
        cpu_params = dict(cpu.named_parameters())
        for name, p in card.named_parameters():
            ref = cpu_params[name].grad
            if p.grad is None or ref is None or \
                    not torch.isfinite(p.grad).all():
                missing.append(name)
                continue
            r = rel(p.grad, ref)
            if r >= grad_err:
                grad_err, grad_name = r, name
    log(f"[card-vs-cpu] LSTR-Mamba fp32, full width, depth {ANT_LAYERS}, "
        f"TF32 off, largest difference over each tensor's scale: "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" (tol {CARD_CPU_ANT_REL_TOL}); short gradients {grad_err:.3e} "
        f"({grad_name}; tol {CARD_CPU_ANT_GRAD_REL_TOL}) in "
        f"{time.perf_counter() - t0:.1f} s")
    if missing or grad_err > CARD_CPU_ANT_GRAD_REL_TOL or \
            not all(math.isfinite(v) and v <= CARD_CPU_ANT_REL_TOL
                    for v in errs.values()):
        raise AssertionError(f"card and CPU LSTR-Mamba disagree: {errs}, "
                             f"gradients {grad_err} (no or non-finite "
                             f"gradient: {missing})")



def mir_inputs(clips, captions, seed, frames=None):
    """``clips`` random clips at the MIR preset's 16 × 224² (or ``frames``
    frames) on the card, and ``captions`` rows of 77 token ids drawn over
    the 49408-entry vocabulary."""
    import torch
    from video_mamba_suite_torch.configs import CLIP_TIMEMAMBA_B_EK100_MIR

    m = CLIP_TIMEMAMBA_B_EK100_MIR["model"]
    vision, text = m["vision_cfg"], m["text_cfg"]
    img = vision["img_size"]
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(clips, frames or vision["num_frames"], img, img, 3,
                    device="cuda", generator=g)
    ids = torch.randint(0, text["vocab_size"],
                        (captions, text["context_length"]), device="cuda",
                        generator=g)
    return x, ids


def serve_mir(model, clips, ids, label):
    """REQUESTS timed CLIP forwards of one request after 2 warm-ups, the
    launch counts zeroed just before and read just after. Returns (the
    last outputs, launches, plain-version calls)."""
    import torch
    from video_mamba_suite_torch.ops import LAUNCHES, reset_launches

    with torch.inference_mode():
        for _ in range(2):
            model(clips, ids)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        times = []
        with count_plain_calls() as plain:
            for _ in range(MIR_REQUESTS):   # each ends with its embeddings
                t0 = time.perf_counter()
                out = model(clips, ids)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
        launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    img, txt, scale = out
    if tuple(img.shape) != (len(clips), 512) or \
            tuple(txt.shape) != (len(ids), 512) or \
            not all(torch.isfinite(t).all() for t in out) or \
            (img.norm(dim=-1) - 1).abs().max() > 1e-4:
        raise AssertionError(f"bad MIR embeddings: {tuple(img.shape)}, "
                             f"{tuple(txt.shape)}")
    times.sort()
    median = statistics.median(times)
    log(f"[mir] {label}: {MIR_REQUESTS} requests of {len(clips)} clips + "
        f"{len(ids)} captions: median {1e3 * median:.3f} ms/request (min "
        f"{1e3 * times[0]:.3f}, max {1e3 * times[-1]:.3f}), "
        f"{len(clips) / median:.2f} clips/s; peak memory "
        f"{peak / 2**30:.2f} GiB; launches {launches}")
    return out, launches, dict(plain)


def run_mir_serving():
    """This slice's main path: EK100 multi-instance retrieval on
    CLIP-TimeMamba-B (``build_clip_mir``: bf16 video tower with its spatial
    attention on K10, fp32 text tower with TF32 matmuls). Requests of 8
    clips and 8 captions through the CLIP forward: exactly 12 K1 and 12 K10
    each and no plain version; the same requests with ``attn_flash=None``
    (12 K1, no K10) as the A/B; then ``MirFinetuner.evaluate`` over 32
    clips x 32 captions."""
    import numpy as np
    import torch
    from video_mamba_suite_torch import build_clip_mir
    from video_mamba_suite_torch.ops import LAUNCHES, reset_launches
    from video_mamba_suite_torch.tasks.egocentric import (
        create_relevancy_matrix,
        get_mAP,
        get_nDCG,
    )

    t0 = time.perf_counter()
    engine = build_clip_mir(attn_flash="row", vision_dtype=torch.bfloat16,
                            seed=0)
    model = engine.model.eval()
    log(f"[mir] CLIP-TimeMamba-B (EK100 MIR) built in "
        f"{time.perf_counter() - t0:.1f} s")
    set_tf32(True)
    clips, ids = mir_inputs(BATCH, MIR_CAPTIONS, seed=21)
    row, launches, plain = serve_mir(model, clips, ids, 'attn_flash="row"')
    want = {"short_bidir_fwd": VISION_DEPTH * MIR_REQUESTS,
            "row_mha_fwd": VISION_DEPTH * MIR_REQUESTS}
    if launches != want or plain:
        raise AssertionError(f"MIR requests launched {launches} (want "
                             f"{want}), plain versions {plain}")
    with torch.inference_mode():
        device = profile("request", lambda: model(clips, ids),
                         tag="profile-mir")
    busy = sum(device.values()) or float("nan")
    k10_ms = route_ms("K10", "bfloat16", device)
    log(f"[mir] K10 ({', '.join(ROUTES[('K10', 'bfloat16')])}) "
        f"{k10_ms:.3f} ms of {busy:.3f} ms of device time a request "
        f"({100 * k10_ms / busy:.1f}%)")
    for blk in model.visual.blocks:                 # the A/B: einsum path
        blk.attn.flash = None
    einsum, ab_launches, plain = serve_mir(model, clips, ids,
                                           "attn_flash=None")
    if ab_launches != {"short_bidir_fwd": VISION_DEPTH * MIR_REQUESTS} or \
            plain:
        raise AssertionError(f"the A/B launched {ab_launches}, plain "
                             f"versions {plain}")
    with torch.inference_mode():
        profile("request", lambda: model(clips, ids), tag="profile-mir-ab")
    diff = max((a - b).abs().max().item() for a, b in zip(row, einsum))
    log(f"[mir] row against einsum path (bf16 video tower): largest "
        f"embedding difference {diff:.3e}")
    for blk in model.visual.blocks:
        blk.attn.flash = "row"

    videos, texts = mir_inputs(MIR_EVAL, MIR_EVAL, seed=22)
    rng = np.random.default_rng(23)            # 4 verbs x 3 nouns a side
    vis = rng.integers(0, 4, MIR_EVAL) * 3 + rng.integers(0, 3, MIR_EVAL)
    txt = rng.integers(0, 4, MIR_EVAL) * 3 + rng.integers(0, 3, MIR_EVAL)
    rel = create_relevancy_matrix(vis, txt)
    reset_launches()
    t0 = time.perf_counter()
    result = engine.evaluate(videos, texts, rel, batch_size=BATCH)
    seconds = time.perf_counter() - t0
    eval_launches = dict(LAUNCHES)
    img, txt_emb = engine.encode_dataset(videos, texts, batch_size=BATCH)
    sim = (img @ txt_emb.T + 1) / 2
    expect = dict(zip(("vis_map", "txt_map", "avg_map"), get_mAP(sim, rel)))
    expect.update(zip(("vis_ndcg", "txt_ndcg", "avg_ndcg"),
                      get_nDCG(sim, rel)))
    batches = -(-MIR_EVAL // BATCH)
    log(f"[mir] evaluate over {MIR_EVAL} clips x {MIR_EVAL} captions in "
        f"{seconds:.2f} s: " + ", ".join(f"{k} {v:.5f}"
                                        for k, v in result.items())
        + f"; launches {eval_launches}")
    if not all(math.isfinite(v) for v in result.values()) or \
            any(abs(result[k] - expect[k]) > 1e-6 for k in expect) or \
            eval_launches != {"short_bidir_fwd": VISION_DEPTH * batches,
                              "row_mha_fwd": VISION_DEPTH * batches}:
        raise AssertionError(f"MIR evaluate: {result} against the metrics "
                             f"of its embeddings {expect}")
    return launches


def card_against_cpu_clip():
    """CLIP-TimeMamba-B at full width and depth (video 12 with K1 and K10,
    text 12) in fp32, TF32 off: one clip and four captions on the card
    through the kernels against the CPU through the plain versions."""
    import torch
    from video_mamba_suite_torch import build_clip_mir
    from video_mamba_suite_torch.ops import LAUNCHES, reset_launches

    set_tf32(False)
    t0 = time.perf_counter()
    cpu = build_clip_mir(device="cpu", seed=5, attn_flash="row").model.eval()
    card = copy.deepcopy(cpu).to("cuda")
    clips, ids = mir_inputs(1, 4, seed=24)
    reset_launches()
    with torch.inference_mode():
        got = card(clips, ids)
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
        want = cpu(clips.cpu(), ids.cpu())
    if launches != {"short_bidir_fwd": VISION_DEPTH,
                    "row_mha_fwd": VISION_DEPTH}:
        raise AssertionError(f"the card's CLIP forward launched {launches}")
    errs = {name: ((g.cpu() - w).abs().max()
                   / w.abs().max().clamp_min(1e-30)).item()
            for name, g, w in zip(("video", "text", "scale"), got, want)}
    log(f"[card-vs-cpu] CLIP-TimeMamba-B fp32, full width, depth 12 + 12, "
        f"TF32 off, largest difference over each output's scale: "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" (tol {CARD_CPU_CLIP_REL_TOL}) in "
        f"{time.perf_counter() - t0:.1f} s")
    if not all(math.isfinite(v) and v <= CARD_CPU_CLIP_REL_TOL
               for v in errs.values()):
        raise AssertionError(f"card and CPU CLIP disagree: {errs}")


# ---------------------------------------------------------------------------
# the flash-attention and complex-scan entry points


def run_flash_module():
    """FusedMHA(flash=True) at the two CLIP-TimeMamba-B widths of
    ``FLASH_MODULE_CASES``, forward and backward (a cotangent on the
    output): exactly one K11 forward and one K11 backward per call, timed
    against the same module on the einsum path (flash=None, no kernel),
    with a torch.profiler window of two calls; then the card against the
    CPU in fp32 with TF32 off on up to 8 rows of the batch (output, the
    input's and every parameter's gradient). Returns the launches of the
    timed calls."""
    import torch
    from video_mamba_suite_torch.models import FusedMHA
    from video_mamba_suite_torch.ops import LAUNCHES, reset_launches

    total = collections.Counter()
    for label, batch, tokens, width, heads, causal, dtype in \
            FLASH_MODULE_CASES:
        set_tf32(False)
        mha = FusedMHA(width, heads, dtype=getattr(torch, dtype),
                       causal=causal, flash=True,
                       generator=torch.Generator().manual_seed(0)).cuda()
        g = torch.Generator(device="cuda").manual_seed(batch + tokens)
        x = torch.randn(batch, tokens, width, device="cuda", generator=g,
                        requires_grad=True)
        cot = torch.randn(batch, tokens, width, device="cuda", generator=g)

        def call():
            x.grad = None
            mha.zero_grad(set_to_none=True)
            out = mha(x)
            out.backward(cot.to(out.dtype))

        def timed(flash):
            mha.flash = flash
            for _ in range(2):
                call()
            torch.cuda.synchronize()
            reset_launches()
            times = []
            for _ in range(FLASH_MODULE_CALLS):
                t0 = time.perf_counter()
                call()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            return statistics.median(times), dict(LAUNCHES)

        flash_s, launches = timed(True)
        want = {"flash_mha_fwd": FLASH_MODULE_CALLS,
                "flash_mha_bwd": FLASH_MODULE_CALLS}
        if launches != want:
            raise AssertionError(f"FusedMHA(flash=True) at {label} launched "
                                 f"{launches}, want {want}")
        device = profile("call", call, tag=f"flash-mha {label}", calls=2,
                         top=8)
        busy = sum(device.values()) or float("nan")
        k11_fwd, k11_bwd = (route_ms(k, dtype, device)
                            for k in ("K11", "K11 bwd"))
        log(f"[flash-mha] {label}: K11 forward {k11_fwd:.4f} ms "
            f"({100 * k11_fwd / busy:.1f}%), backward {k11_bwd:.4f} ms "
            f"({100 * k11_bwd / busy:.1f}%) of {busy:.4f} ms of device time "
            f"a call")
        if not all(torch.isfinite(t).all() for t in
                   (x.grad, *(p.grad for p in mha.parameters()))):
            raise AssertionError(f"FusedMHA(flash=True) at {label}: "
                                 "gradients that are not finite")
        total.update(launches)
        einsum_s, ab_launches = timed(None)
        if ab_launches:
            raise AssertionError(f"the einsum path launched {ab_launches}")
        log(f"[flash-mha] {label} (B {batch}, L {tokens}, D {width}, "
            f"{heads} heads, {'causal' if causal else 'full'}, {dtype}): "
            f"forward + backward median {1e3 * flash_s:.3f} ms with K11, "
            f"{1e3 * einsum_s:.3f} ms on the einsum path; launches "
            f"{launches}")

        rows = min(batch, 8)
        cpu = FusedMHA(width, heads, causal=causal, flash=True,
                       generator=torch.Generator().manual_seed(1))
        card = copy.deepcopy(cpu).cuda()
        xs = x.detach()[:rows].float()
        gs = cot[:rows]
        results = []
        for module, dev in ((card, "cuda"), (cpu, "cpu")):
            xi = xs.to(dev).clone().requires_grad_()
            reset_launches()
            out = module(xi)
            out.backward(gs.to(dev))
            if dev == "cuda":
                torch.cuda.synchronize()
                if dict(LAUNCHES) != {"flash_mha_fwd": 1,
                                      "flash_mha_bwd": 1}:
                    raise AssertionError(f"the card's fp32 FusedMHA "
                                         f"launched {dict(LAUNCHES)}")
            results.append([out.detach().cpu(), xi.grad.cpu()]
                           + [p.grad.cpu() for p in module.parameters()])
        # a value that is not finite on either side makes its error NaN or
        # inf (torch's max keeps a NaN)
        errs = [((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                .item() for a, b in zip(*results)]
        err = max(errs)
        log(f"[flash-mha] {label} card (K11) against CPU (einsum path), "
            f"fp32, TF32 off, {rows} rows: largest difference over each "
            f"output's scale {err:.3e} (tol {CARD_CPU_FLASH_REL_TOL})")
        if not all(math.isfinite(e) and e <= CARD_CPU_FLASH_REL_TOL
                   for e in errs):
            raise AssertionError(f"FusedMHA(flash=True) at {label}: card "
                                 f"and CPU disagree ({err:.3e})")
    return dict(total)


def run_vmem_module():
    """``FusedMHA(flash="vmem")`` forward at ``VMEM_MODULE_CASE`` (bf16, no
    gradient), the entry through which K9 is reached: exactly one K9 per
    call, timed (median ms per call) against the same module on the einsum
    path (flash=None, no kernel), with the card's name and power limit.
    Returns the launches of the timed calls."""
    import torch
    from video_mamba_suite_torch.models import FusedMHA
    from video_mamba_suite_torch.ops import LAUNCHES, reset_launches

    label, batch, tokens, width, heads, dtype = VMEM_MODULE_CASE
    mha = FusedMHA(width, heads, dtype=getattr(torch, dtype), flash="vmem",
                   generator=torch.Generator().manual_seed(0)).cuda()
    g = torch.Generator(device="cuda").manual_seed(batch + tokens)
    x = torch.randn(batch, tokens, width, device="cuda", generator=g)

    def timed(flash):
        mha.flash = flash
        with torch.inference_mode():
            for _ in range(2):
                out = mha(x)
            torch.cuda.synchronize()
            reset_launches()
            times = []
            for _ in range(VMEM_MODULE_CALLS):
                t0 = time.perf_counter()
                out = mha(x)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
        if out.shape != x.shape or not torch.isfinite(out).all():
            raise AssertionError(f"FusedMHA(flash={flash!r}) at {label}: "
                                 f"{tuple(out.shape)} or values that are "
                                 "not finite")
        return statistics.median(times), dict(LAUNCHES)

    vmem_s, launches = timed("vmem")
    want = {"vision_mha_fwd": VMEM_MODULE_CALLS}
    if launches != want:
        raise AssertionError(f"FusedMHA(flash='vmem') at {label} launched "
                             f"{launches}, want {want}")
    einsum_s, ab_launches = timed(None)
    if ab_launches:
        raise AssertionError(f"the einsum path launched {ab_launches}")
    log(f"[vmem-mha] {label} (B {batch}, L {tokens}, D {width}, {heads} "
        f"heads, {dtype}) on {card_line()}: forward median "
        f"{1e3 * vmem_s:.3f} ms with K9, {1e3 * einsum_s:.3f} ms on the "
        f"einsum path; launches {launches}")
    return launches


def run_complex_scan():
    """``selective_scan`` with complex A at the scan microbench shape
    (``COMPLEX_SHAPE``, fp32, D, z, bias, softplus and a complex initial
    state), forward and backward through autograd with a cotangent on the
    output and on the complex last state: exactly one K7 and one K8 per
    call and no other kernel; without a backward one K7 alone. Then the
    card against the plain version on the card on 2 rows of the batch:
    output, last state and every input's gradient. Returns the launches
    of the timed calls."""
    import torch
    from video_mamba_suite_torch.ops import (
        LAUNCHES,
        reset_launches,
        selective_scan,
        selective_scan_ref,
    )

    set_tf32(False)
    args = k7_inputs(COMPLEX_SHAPE, "float32", seed=71, h0=True)
    A = torch.complex(args.pop("Ar"), args.pop("Ai"))
    h0 = torch.complex(args.pop("h0r"), args.pop("h0i"))
    g = torch.Generator(device="cuda").manual_seed(72)
    cot = torch.randn(args["u"].shape, device="cuda", generator=g)
    glast = torch.randn(h0.shape, dtype=torch.complex64, device="cuda",
                        generator=g)
    names = ("u", "delta", "B", "C", "D", "z", "delta_bias")

    def call(fn, rows=None, grad=True):
        leaves = {k: args[k][:rows].detach().requires_grad_(grad)
                  if k in ("u", "delta", "B", "C", "z")
                  else args[k].detach().requires_grad_(grad) for k in names}
        a = A.detach().requires_grad_(grad)
        h = h0[:rows].detach().requires_grad_(grad)
        out, last = fn(leaves["u"], leaves["delta"], a, leaves["B"],
                       leaves["C"], D=leaves["D"], z=leaves["z"],
                       delta_bias=leaves["delta_bias"], delta_softplus=True,
                       return_last_state=True, initial_state=h)
        if grad:
            loss = ((out * cot[:rows]).sum()
                    + (last * glast[:rows].conj()).real.sum())
            loss.backward()
        return [out.detach(), last.detach()] + (
            [leaves[k].grad for k in names] + [a.grad, h.grad] if grad
            else [])

    call(selective_scan)                                    # warm-up
    torch.cuda.synchronize()
    reset_launches()
    times = []
    for _ in range(COMPLEX_CALLS):
        t0 = time.perf_counter()
        got = call(selective_scan)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = dict(LAUNCHES)
    want = {"complex_scan_fwd": COMPLEX_CALLS,
            "complex_scan_bwd": COMPLEX_CALLS}
    if launches != want or not all(torch.isfinite(t).all() for t in got):
        raise AssertionError(f"selective_scan with complex A launched "
                             f"{launches} (want {want}) or gave values that "
                             "are not finite")
    reset_launches()
    with torch.no_grad():
        t0 = time.perf_counter()
        call(selective_scan, grad=False)
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
    if dict(LAUNCHES) != {"complex_scan_fwd": 1}:
        raise AssertionError(f"the forward alone launched {dict(LAUNCHES)}")
    log(f"[complex-scan] selective_scan, complex A, {COMPLEX_SHAPE} fp32: "
        f"forward + backward median {1e3 * statistics.median(times):.2f} "
        f"ms, forward alone {1e3 * fwd_s:.2f} ms; launches {launches}")

    reset_launches()
    got = call(selective_scan, rows=2)
    torch.cuda.synchronize()
    kernel_launches = dict(LAUNCHES)
    want = call(selective_scan_ref, rows=2)
    labels = ("out", "last state") + names + ("A", "initial_state")
    errs = {k: ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
            for k, a, b in zip(labels, got, want)}
    worst = max(errs.values())
    log(f"[complex-scan] card (K7, K8) against the plain version on the "
        f"card, 2 rows, fp32: largest difference over each output's scale "
        f"{worst:.3e} (tol {COMPLEX_PLAIN_REL_TOL}); launches "
        f"{kernel_launches}")
    if kernel_launches != {"complex_scan_fwd": 1, "complex_scan_bwd": 1} \
            or not all(math.isfinite(e) and e <= COMPLEX_PLAIN_REL_TOL
                       for e in errs.values()):
        raise AssertionError(f"complex selective_scan against its plain "
                             f"version: {errs}")
    return launches


def profile_seen(what, fn, tag, tries=4, calls=2):
    """``profile`` of ``calls`` calls repeated, up to ``tries`` sessions,
    until a session records device time (late in this script a session
    can record none)."""
    for _ in range(tries):
        device = profile(what, fn, tag=tag, calls=calls)
        if device:
            return device
    return {}


def tal_batch(config, batch, seed):
    """``batch`` synthetic videos at the configuration's widths (its
    feature width, classes and training length), collated and staged on
    the card once: (items, [feats, mask, segments, labels, valid])."""
    import torch
    from video_mamba_suite_torch.tasks.tal import (
        collate_tal,
        make_synthetic_tal,
    )

    d = config["dataset"]
    items = make_synthetic_tal(batch, d["num_classes"], d["input_dim"],
                               d["max_seq_len"], seed=seed)
    arrays = collate_tal(items, d["max_seq_len"], TAL_MAX_GT)
    return items, [torch.as_tensor(a).cuda() for a in arrays]


def run_tal_train(label, config, want):
    """ActionMamba's train step at a preset's full widths
    (``build_tal_trainer``: AdamW, warmup-cosine, clip 1.0, EMA 0.999,
    drop-path 0.1 from the trainer's generator on the card; fp32, the
    convolutions and matmuls at PyTorch's defaults) on synthetic features
    staged on the card once: 2 warm-ups (every parameter a finite
    gradient), then ``TAL_STEPS`` timed steps, each ending with its loss
    dict read, with exactly ``want`` scan launches a step (K3 with
    checkpoints), no other scan kernel and no plain version. Returns the
    trainer and the timed steps' launches."""
    import torch
    from video_mamba_suite_torch import build_tal_trainer
    from video_mamba_suite_torch.ops import LAUNCHES, reset_launches

    t0 = time.perf_counter()
    trainer = build_tal_trainer(config, seed=0)
    model = trainer.model
    batch = config["loader"]["batch_size"]
    _, arrays = tal_batch(config, batch, seed=16)
    log(f"[tal-train] {label}: built and staged in "
        f"{time.perf_counter() - t0:.1f} s; "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.2f} M "
        f"parameters, levels {model.level_lengths(arrays[0].shape[1])}")
    losses = [trainer.train_step(*arrays)]                   # warm-up
    bad = [n for n, p in model.named_parameters()
           if p.grad is None or not torch.isfinite(p.grad).all()]
    if bad:
        raise AssertionError(f"{label}: no or non-finite gradient at {bad}")
    first = [p.detach().clone() for p in model.parameters()]
    losses.append(trainer.train_step(*arrays))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    times = []
    with count_plain_calls() as plain, count_checkpoint_writes() as ck:
        for _ in range(TAL_STEPS):
            t0 = time.perf_counter()
            losses.append(trainer.train_step(*arrays))
            times.append(time.perf_counter() - t0)
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    want_all = {k: v * TAL_STEPS for k, v in want.items()}
    writes = ck["chunked_scan_fwd with checkpoints"]
    if launches != want_all or sum(plain.values()) or \
            writes != want_all["chunked_scan_fwd"]:
        raise AssertionError(f"{label} train steps launched {launches} "
                             f"(want {want_all}), plain-version calls "
                             f"{dict(plain)}, checkpoint writes {writes}")
    moved = sum(not torch.equal(a, p.detach())
                for a, p in zip(first, model.parameters()))
    if not all(math.isfinite(v) for step in losses for v in step.values()) \
            or moved < len(first) // 2:
        raise AssertionError(f"{label}: losses {losses}, {moved} of "
                             f"{len(first)} parameters moved")
    times.sort()
    median = statistics.median(times)
    log(f"[tal-train] {label}: {TAL_STEPS} steps of {batch} videos x "
        f"{arrays[0].shape[1]} steps x {arrays[0].shape[2]} features, fp32, "
        f"on {card_line()}: median {1e3 * median:.2f} ms/step (min "
        f"{1e3 * times[0]:.2f}, max {1e3 * times[-1]:.2f}), "
        f"{batch / median:.1f} videos/s; peak memory {peak / 2**30:.2f} "
        f"GiB; launches {launches}, checkpoint writes {writes}, "
        f"plain-version calls {dict(plain)}; {moved} of {len(first)} "
        f"parameters moved")
    log(f"[tal-train] {label} final_loss by step (the normaliser moving "
        f"from 100): "
        + " ".join(f"{step['final_loss']:.5f}" for step in losses))
    profile_seen("step", lambda: trainer.train_step(*arrays),
                 tag=f"profile-tal-train-{label}")
    return trainer, launches


def run_tal_eval(trainer, config):
    """THUMOS eval: ``predict_video`` (the EMA weights; 14 K3 a video,
    without checkpoints, then the decode on the card, soft-NMS and voting
    on the host) over ``TAL_EVAL_VIDEOS`` synthetic videos of the
    preset's length, ms per video; then ``evaluate``'s mAP over them (a
    number with no target: random weights, synthetic data); then its
    parts timed apart, NMS by numpy and by the native op
    (``tal_eval_breakdown``)."""
    import numpy as np
    import torch
    from video_mamba_suite_torch.ops import LAUNCHES, reset_launches
    from video_mamba_suite_torch.tasks.tal import make_synthetic_tal

    d = config["dataset"]
    items = make_synthetic_tal(TAL_EVAL_VIDEOS, d["num_classes"],
                               d["input_dim"], d["max_seq_len"], seed=17)
    trainer.predict_video(items[0])                          # warm-up
    torch.cuda.synchronize()
    reset_launches()
    times, kept = [], []
    with count_plain_calls() as plain, count_checkpoint_writes() as ck:
        for item in items:
            t0 = time.perf_counter()
            out = trainer.predict_video(item)
            times.append(time.perf_counter() - t0)
            kept.append(len(out["segments"]))
            if not (np.isfinite(out["segments"]).all()
                    and np.isfinite(out["scores"]).all()):
                raise AssertionError(f"predict_video gave values that are "
                                     f"not finite: {out}")
    launches = dict(LAUNCHES)
    want = {"chunked_scan_fwd": 14 * len(items)}
    writes = ck["chunked_scan_fwd with checkpoints"]
    if launches != want or writes or sum(plain.values()):
        raise AssertionError(f"predict_video launched {launches} (want "
                             f"{want}), checkpoint writes {writes}, "
                             f"plain-version calls {dict(plain)}")
    t0 = time.perf_counter()
    mAP, avg = trainer.evaluate(items)
    eval_s = time.perf_counter() - t0
    if not np.isfinite(mAP).all():
        raise AssertionError(f"evaluate's mAP is not finite: {mAP}")
    times.sort()
    log(f"[tal-eval] THUMOS predict_video, {len(items)} synthetic videos "
        f"of {d['max_seq_len']} steps on {card_line()}: median "
        f"{1e3 * statistics.median(times):.2f} ms/video (min "
        f"{1e3 * times[0]:.2f}, max {1e3 * times[-1]:.2f}), detections "
        f"kept {kept}; launches {launches}; evaluate over them "
        f"{1e3 * eval_s:.1f} ms, mAP at tIoU 0.3-0.7 "
        f"{' '.join(f'{v:.4f}' for v in mAP)}, average {avg:.4f} "
        f"(synthetic data, random weights: no target)")
    model = trainer.inference_model()
    feats = torch.as_tensor(items[0]["feats"].T[None]).cuda()
    mask = torch.ones(feats.shape[:2], device="cuda")
    with torch.inference_mode():
        profile_seen("video forward", lambda: model(feats, mask),
                     tag="profile-tal-eval")
    tal_eval_breakdown(trainer, items, "tal-eval")


def card_against_cpu_tal():
    """ActionMamba at THUMOS-14's full width and depth (``TAL_THUMOS``),
    fp32 with TF32 off: the card through the kernels against the CPU
    through the plain versions, one synthetic video of 2000 steps padded to
    2304, the drop-path scales set to 1 (the mixers count; eval mode, no
    drop). The logits and offsets of every level; then one step's
    gradient at every parameter (label assignment, focal and DIoU losses,
    backward)."""
    import torch
    from video_mamba_suite_torch.configs import TAL_THUMOS
    from video_mamba_suite_torch.ops import LAUNCHES, reset_launches
    from video_mamba_suite_torch.tasks.tal import (
        ActionMambaDetector,
        collate_tal,
        label_points,
        make_synthetic_tal,
        tal_losses,
    )

    set_tf32(False)
    t0 = time.perf_counter()
    d, m = TAL_THUMOS["dataset"], TAL_THUMOS["model"]
    cpu = ActionMambaDetector(
        d["input_dim"], d["num_classes"], max_seq_len=d["max_seq_len"],
        embd_dim=m["embd_dim"], backbone_arch=tuple(m["backbone_arch"]),
        regression_range=m["regression_range"], device="cpu", seed=1)
    with torch.no_grad():
        for name, p in cpu.named_parameters():
            if name.endswith("drop_path.scale"):
                p.fill_(1.0)
    card = copy.deepcopy(cpu).to("cuda")
    item = make_synthetic_tal(1, d["num_classes"], d["input_dim"], 2000,
                              seed=18)[0]
    feats, mask, segs, labels, valid = (
        torch.as_tensor(a) for a in collate_tal([item], d["max_seq_len"],
                                                TAL_MAX_GT))
    points = torch.cat([torch.from_numpy(p) for p in cpu.make_points()(
        cpu.level_lengths(d["max_seq_len"]))])

    def rel(got, want):
        return ((got.detach().cpu() - want).abs().max()
                / want.abs().max().clamp_min(1e-30)).item()

    reset_launches()
    with torch.inference_mode():
        want = cpu.eval()(feats, mask)
        got = card.eval()(feats.cuda(), mask.cuda())
        torch.cuda.synchronize()
    errs = {kind: max(rel(g, w) for g, w in zip(gs, ws))
            for kind, gs, ws in zip(("logits", "offsets"), got, want)}
    fwd_launches = dict(LAUNCHES)
    reset_launches()
    grads = []
    for model, dev in ((cpu, "cpu"), (card, "cuda")):
        gt_cls, gt_off = label_points(points.to(dev), segs.to(dev),
                                      labels.to(dev), valid.to(dev),
                                      d["num_classes"])
        cls_logits, offsets, masks = model(feats.to(dev), mask.to(dev))
        losses, _ = tal_losses(masks, cls_logits, offsets, gt_cls, gt_off,
                               torch.tensor(100.0, device=dev),
                               d["num_classes"])
        losses["final_loss"].backward()
        grads.append(dict(model.named_parameters()))
    torch.cuda.synchronize()
    bwd_launches = dict(LAUNCHES)
    grad_err, grad_name, missing = 0.0, "", []
    for name, p in grads[1].items():
        ref = grads[0][name].grad
        if p.grad is None or ref is None or not torch.isfinite(p.grad).all():
            missing.append(name)
            continue
        r = rel(p.grad, ref)
        if r >= grad_err:
            grad_err, grad_name = r, name
    log(f"[card-vs-cpu] ActionMamba THUMOS-14 fp32, full width and depth, "
        f"TF32 off, one video of 2000 steps in 2304: logits "
        f"{errs['logits']:.3e}, offsets {errs['offsets']:.3e} (tol "
        f"{CARD_CPU_TAL_REL_TOL}); gradients {grad_err:.3e} ({grad_name}; "
        f"tol {CARD_CPU_TAL_GRAD_REL_TOL}); launches forward "
        f"{fwd_launches}, step {bwd_launches}; "
        f"{time.perf_counter() - t0:.1f} s")
    if fwd_launches != {"chunked_scan_fwd": 14} or \
            bwd_launches != TAL_THUMOS_LAUNCHES:
        raise AssertionError(f"the card's ActionMamba launched "
                             f"{fwd_launches} and {bwd_launches}")
    if missing or not grad_err <= CARD_CPU_TAL_GRAD_REL_TOL or \
            not all(e <= CARD_CPU_TAL_REL_TOL for e in errs.values()):
        raise AssertionError(f"card and CPU ActionMamba disagree: {errs}, "
                             f"gradients {grad_err} at {grad_name} (no or "
                             f"non-finite gradient: {missing})")


# ---------------------------------------------------------------------------
# egocentric training (CLIP fine-tuning and pretraining, EK100
# classification) and the rest of the Mamba LM (int8 serving, scoring)


def train_phase(tag, trainer, batch, steps, want, clips):
    """2 warm-up steps of ``trainer.train_step(*batch)`` (every parameter a
    finite gradient after the first), then ``steps`` timed steps, each
    ending with its loss read, with exactly ``want`` launches a step, no
    plain version and (for K3) every K3 writing checkpoints; ms/step,
    clips/s, peak memory and a profile window. Returns the timed steps'
    launches."""
    import torch
    from video_mamba_suite_torch.ops import LAUNCHES, reset_launches

    model = trainer.model
    losses = [trainer.train_step(*batch)]
    bad = [n for n, p in model.named_parameters()
           if p.grad is None or not torch.isfinite(p.grad).all()]
    if bad:
        raise AssertionError(f"{tag}: no or non-finite gradient at {bad}")
    losses.append(trainer.train_step(*batch))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    times = []
    with count_plain_calls() as plain, count_checkpoint_writes() as ck:
        for _ in range(steps):
            t0 = time.perf_counter()
            losses.append(trainer.train_step(*batch))
            times.append(time.perf_counter() - t0)
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    want_all = {k: v * steps for k, v in want.items()}
    writes = ck["chunked_scan_fwd with checkpoints"]
    if launches != want_all or sum(plain.values()) or \
            writes != want_all.get("chunked_scan_fwd", 0):
        raise AssertionError(f"{tag} launched {launches} in {steps} steps "
                             f"(want {want_all}), plain-version calls "
                             f"{dict(plain)}, checkpoint writes {writes}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{tag}: non-finite loss {losses}")
    times.sort()
    median = statistics.median(times)
    log(f"[{tag}] {steps} steps of {clips} clips on {card_line()}: median "
        f"{1e3 * median:.2f} ms/step (min {1e3 * times[0]:.2f}, max "
        f"{1e3 * times[-1]:.2f}), {clips / median:.2f} clips/s; peak memory "
        f"{peak / 2**30:.2f} GiB; launches {launches}, checkpoint writes "
        f"{writes}, plain-version calls {dict(plain)}")
    log(f"[{tag}] loss by step: {' '.join(f'{v:.5f}' for v in losses)}")
    profile_seen("step", lambda: trainer.train_step(*batch),
                 tag=f"profile-{tag}")
    return launches


CLIP_STEP_LAUNCHES = {"short_bidir_fwd": VISION_DEPTH,
                      "row_mha_fwd": VISION_DEPTH,
                      "short_bidir_bwd": VISION_DEPTH}


def run_mir_train():
    """EK100 MIR fine-tuning, this slice's headline: ``build_clip_mir``
    (CLIP-TimeMamba-B at the ego_ek100_mir widths, bf16 video tower with
    its spatial attention on K10, fp32 text tower with TF32 matmuls; the
    preset's lr 1e-5, weight decay 0.01, AdamW b2 0.98, warmup-cosine,
    clip 1.0), ``MirFinetuner.train_step`` on 8 clips (16 × 224²) and 8
    captions of 77 tokens: 12 K1, 12 K10 and 12 K2 a step."""
    import torch
    from video_mamba_suite_torch import build_clip_mir

    t0 = time.perf_counter()
    trainer = build_clip_mir(attn_flash="row", vision_dtype=torch.bfloat16,
                             seed=0)
    log(f"[mir-train] CLIP-TimeMamba-B (EK100 MIR) built in "
        f"{time.perf_counter() - t0:.1f} s; learning rate "
        f"{trainer.schedule(0):.3g} at step 0, {trainer.schedule(100):.3g} "
        f"at 100")
    set_tf32(True)
    clips, ids = mir_inputs(BATCH, BATCH, seed=31)
    return train_phase("mir-train", trainer, (clips, ids), MIR_TRAIN_STEPS,
                       CLIP_STEP_LAUNCHES, BATCH)


def run_clip_pretrain():
    """CLIP pretraining at the ego_timemamba_pretrain widths
    (``build_clip_pretrainer``: 4 frames, frozen-in-time, tanh gates, lr
    3e-5, weight decay 0.01, b2 0.98; bf16 video tower on K10), 32 clips
    and 32 captions a step on one card: 12 K1 (4 steps, rounded up to 8),
    12 K10 and 12 K2 a step."""
    import torch
    from video_mamba_suite_torch import build_clip_pretrainer
    from video_mamba_suite_torch.configs import EGO_TIMEMAMBA_PRETRAIN

    frames = EGO_TIMEMAMBA_PRETRAIN["model"]["vision_cfg"]["num_frames"]
    t0 = time.perf_counter()
    trainer = build_clip_pretrainer(attn_flash="row",
                                    vision_dtype=torch.bfloat16, seed=0)
    log(f"[pretrain] CLIP-TimeMamba-B ({frames} frames) built in "
        f"{time.perf_counter() - t0:.1f} s")
    set_tf32(True)
    clips, ids = mir_inputs(PRETRAIN_BATCH, PRETRAIN_BATCH, seed=32,
                            frames=frames)
    launches = train_phase("pretrain", trainer, (clips, ids),
                           PRETRAIN_STEPS, CLIP_STEP_LAUNCHES,
                           PRETRAIN_BATCH)
    img, txt, scale = trainer.encode(clips[:BATCH], ids[:BATCH])
    if img.shape != (BATCH, 512) or not (math.isfinite(scale) and scale > 0):
        raise AssertionError(f"pretrain encode: {img.shape}, {scale}")
    return launches


def run_ek100_cls():
    """EK100 action classification (``build_ek100_cls``: ViViM-T, 16 ×
    224², 3806 actions, mixup 0.8 / cutmix 1.0, smoothing 0.1, lr 1e-4;
    fp32 with TF32 matmuls) on 8 clips a step: 48 K3 with checkpoints and
    48 K4 a step; then ``evaluate`` over 16 clips × 2 crops with verb and
    noun marginals (48 K3 a batch of 8 crops, no checkpoints)."""
    import numpy as np
    import torch
    from video_mamba_suite_torch import build_ek100_cls
    from video_mamba_suite_torch.ops import LAUNCHES, reset_launches
    from video_mamba_suite_torch.tasks.egocentric import get_marginal_indexes

    t0 = time.perf_counter()
    trainer = build_ek100_cls(seed=0)
    log(f"[cls] ViViM-T EK100 classifier built in "
        f"{time.perf_counter() - t0:.1f} s: "
        f"{trainer.num_classes} actions, mixup {trainer.mixup_alpha}, "
        f"cutmix {trainer.cutmix_alpha}")
    set_tf32(True)
    x = vivim_clips(BATCH, seed=33)
    labels = torch.randint(trainer.num_classes, (BATCH,), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(33))
    launches = train_phase(
        "cls", trainer, (x, labels), CLS_STEPS,
        {"chunked_scan_fwd": VIVIM_LAUNCHES,
         "chunked_scan_bwd": VIVIM_LAUNCHES}, BATCH)

    views = vivim_clips(CLS_EVAL_CLIPS * CLS_EVAL_CROPS, seed=34).reshape(
        CLS_EVAL_CLIPS, CLS_EVAL_CROPS, *x.shape[1:])
    rng = np.random.default_rng(34)
    eval_labels = rng.integers(0, trainer.num_classes, CLS_EVAL_CLIPS)
    to_verb = get_marginal_indexes(
        rng.integers(0, EK100_VERBS, trainer.num_classes), EK100_VERBS)
    to_noun = get_marginal_indexes(
        rng.integers(0, EK100_NOUNS, trainer.num_classes), EK100_NOUNS)
    reset_launches()
    t0 = time.perf_counter()
    with count_plain_calls() as plain:
        result = trainer.evaluate(views, eval_labels, batch_size=BATCH,
                                  action_to_verb=to_verb,
                                  action_to_noun=to_noun)
    seconds = time.perf_counter() - t0
    eval_launches = dict(LAUNCHES)
    batches = -(-CLS_EVAL_CLIPS * CLS_EVAL_CROPS // BATCH)
    log(f"[cls] evaluate over {CLS_EVAL_CLIPS} clips x {CLS_EVAL_CROPS} "
        f"crops in {seconds:.2f} s: " + ", ".join(
            f"{k} {v:.2f}" for k, v in result.items())
        + f"; launches {eval_launches}")
    if len(result) != 6 or not all(0 <= v <= 100 for v in result.values()) \
            or eval_launches != {"chunked_scan_fwd": VIVIM_LAUNCHES
                                 * batches} or sum(plain.values()):
        raise AssertionError(f"classification evaluate: {result}, launches "
                             f"{eval_launches}, plain versions "
                             f"{dict(plain)}")
    return launches


def lm_requests(model, ids, config):
    """A warm-up ``generate`` request, then ``LM_INT8_REQUESTS`` timed ones
    with the launch counts zeroed just before and read just after.
    Returns (the last output, sorted times, launches, plain calls)."""
    import torch
    from video_mamba_suite_torch import generate
    from video_mamba_suite_torch.ops import LAUNCHES, reset_launches

    def request():
        out = generate(model, ids, config)
        torch.cuda.synchronize()
        return out

    request()
    reset_launches()
    times = []
    with count_plain_calls() as plain, count_checkpoint_writes() as ck:
        for _ in range(LM_INT8_REQUESTS):
            t0 = time.perf_counter()
            out = request()
            times.append(time.perf_counter() - t0)
    plain.update(ck)
    return out, sorted(times), dict(LAUNCHES), dict(plain)


def run_lm_int8():
    """Mamba-130M int8 serving: ``quantize_lm_for_decode`` of the fp32
    model (int8 in_proj, out_proj and embedding, the rest bf16), then
    ``generate`` of 8 prompts of 16 x 128 new tokens: exactly 24 K5 a
    request (the prefill), no plain version; the bf16 model of the same
    seed as the A/B (int8, bf16, int8 again). Tokens/s, the bytes of
    weights, and each model's device ms a generated token from a profile
    of a request of ``LM_PROFILE_NEW`` new tokens."""
    import torch
    from video_mamba_suite_torch import (
        GenerationConfig,
        build_mamba_lm,
        generate,
        quantize_lm_for_decode,
    )
    from video_mamba_suite_torch.configs import MAMBA_130M

    t0 = time.perf_counter()
    int8 = quantize_lm_for_decode(build_mamba_lm(MAMBA_130M, seed=0))
    bf16 = build_mamba_lm(MAMBA_130M, dtype=torch.bfloat16, seed=0)
    sizes = {}
    for name, model in (("int8", int8), ("bf16", bf16)):
        tensors = list(model.parameters()) + list(model.buffers())
        sizes[name] = sum(t.numel() * t.element_size() for t in tensors)
    log(f"[lm-int8] Mamba-130M quantized in {time.perf_counter() - t0:.1f} "
        f"s: weights {sizes['int8'] / 1e6:.1f} MB int8 (+ bf16 rest, fp32 "
        f"scales) against {sizes['bf16'] / 1e6:.1f} MB bf16")
    ids = lm_prompt(int8, LM_BATCH, LM_PROMPT, seed=9)
    config = GenerationConfig(max_length=LM_PROMPT + LM_NEW)
    want = {"short_scan_fwd": int8.n_layer * LM_INT8_REQUESTS}
    results = {}
    for name, model in (("int8", int8), ("bf16", bf16),
                        ("int8 again", int8)):
        out, times, launches, plain = lm_requests(model, ids, config)
        if launches != want or sum(plain.values()) or \
                tuple(out.shape) != (LM_BATCH, LM_PROMPT + LM_NEW) or \
                not torch.equal(out[:, :LM_PROMPT], ids):
            raise AssertionError(f"{name} serving launched {launches} (want "
                                 f"{want}), plain versions {plain}")
        median = statistics.median(times)
        results[name] = out
        log(f"[lm-int8] {name}: {LM_INT8_REQUESTS} requests of {LM_BATCH} x "
            f"({LM_PROMPT} + {LM_NEW}) tokens on {card_line()}: median "
            f"{1e3 * median:.2f} ms/request (min {1e3 * times[0]:.2f}, max "
            f"{1e3 * times[-1]:.2f}), {LM_BATCH * LM_NEW / median:.1f} "
            f"generated tok/s; launches {launches}")
    with torch.inference_mode():
        a = int8.prefill(ids)[0].float()
        b = bf16.prefill(ids)[0].float()
    same = (results["int8"] == results["bf16"]).float().mean().item()
    log(f"[lm-int8] int8 against bf16: prefill logits' largest difference "
        f"over their scale {((a - b).abs().max() / b.abs().max()).item():.3e}"
        f"; {100 * same:.1f}% of the generated ids equal")
    if not torch.isfinite(a).all() or \
            not torch.equal(results["int8"], results["int8 again"]):
        raise AssertionError("int8 serving: non-finite logits or greedy "
                             "output that changed between requests")
    short = GenerationConfig(max_length=LM_PROMPT + LM_PROFILE_NEW)
    device = {}
    for name, model in (("int8", int8), ("bf16", bf16)):
        device[name] = sum(profile_seen(
            f"request of {LM_PROFILE_NEW} new tokens",
            lambda: generate(model, ids, short), tag=f"profile-lm-{name}",
            calls=1).values())
    log(f"[lm-int8] device time a generated token: int8 "
        f"{device['int8'] / LM_PROFILE_NEW:.3f} ms, bf16 "
        f"{device['bf16'] / LM_PROFILE_NEW:.3f} ms (the prefill included)")
    return {"short_scan_fwd": 3 * want["short_scan_fwd"]}


class CharTokenizer:
    """A character tokenizer with the harness's encode / decode surface:
    ids 1..29 over lower-case letters, space and '.?!' (the JAX package's
    tests use the same)."""

    alphabet = " abcdefghijklmnopqrstuvwxyz.?!"

    def encode(self, s):
        return [self.alphabet.index(c) + 1 for c in s.lower()
                if c in self.alphabet]

    def decode(self, ids):
        return "".join(self.alphabet[i - 1] for i in ids
                       if 1 <= i <= len(self.alphabet))


def run_lm_loglik():
    """Mamba-130M scoring (bf16): ``perplexity`` of 8 x 1024 tokens (one
    forward, 24 K3), then ``MambaHarnessLM.loglikelihood`` of 16 requests
    (contexts of 100-160 characters and continuations of 5-20 through a
    character tokenizer) in batches of 8 (24 K3 a batch)."""
    import numpy as np
    import torch
    from video_mamba_suite_torch import (
        MambaHarnessLM,
        build_mamba_lm,
        perplexity,
    )
    from video_mamba_suite_torch.configs import MAMBA_130M
    from video_mamba_suite_torch.ops import LAUNCHES, reset_launches

    model = build_mamba_lm(MAMBA_130M, dtype=torch.bfloat16, seed=0)
    ids = lm_prompt(model, LL_BATCH, LL_LENGTH, seed=12)
    perplexity(model, ids)                              # warm-up
    torch.cuda.synchronize()
    reset_launches()
    with count_plain_calls() as plain:
        t0 = time.perf_counter()
        ppl = perplexity(model, ids)
        seconds = time.perf_counter() - t0
    ppl_launches = dict(LAUNCHES)
    log(f"[lm-loglik] perplexity of {LL_BATCH} x {LL_LENGTH} tokens on "
        f"{card_line()}: {ppl:.1f} (random weights) in {1e3 * seconds:.2f} "
        f"ms, {LL_BATCH * LL_LENGTH / seconds:.0f} scored tok/s; launches "
        f"{ppl_launches}")
    if not (math.isfinite(ppl) and ppl > 1) or sum(plain.values()) or \
            ppl_launches != {"chunked_scan_fwd": model.n_layer}:
        raise AssertionError(f"perplexity {ppl}, launches {ppl_launches}, "
                             f"plain versions {dict(plain)}")
    rng = np.random.default_rng(13)
    letters = np.array(list(CharTokenizer.alphabet[:27]))

    def text(lo, hi):
        return "".join(rng.choice(letters, int(rng.integers(lo, hi))))

    requests = [(text(100, 160), " " + text(5, 20))
                for _ in range(LL_REQUESTS)]
    lm = MambaHarnessLM(model, CharTokenizer(), batch_size=BATCH)
    lm.loglikelihood(requests[:BATCH])                  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    with count_plain_calls() as plain:
        t0 = time.perf_counter()
        scores = lm.loglikelihood(requests)
        seconds = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    batches = -(-LL_REQUESTS // BATCH)
    log(f"[lm-loglik] loglikelihood of {LL_REQUESTS} requests in "
        f"{1e3 * seconds:.2f} ms ({1e3 * seconds / LL_REQUESTS:.2f} "
        f"ms/request); first scores "
        + ", ".join(f"({ll:.2f}, {greedy})" for ll, greedy in scores[:3])
        + f"; launches {launches}")
    if len(scores) != LL_REQUESTS or \
            not all(math.isfinite(ll) and ll < 0 for ll, _ in scores) or \
            launches != {"chunked_scan_fwd": model.n_layer * batches} or \
            sum(plain.values()):
        raise AssertionError(f"loglikelihood: {scores}, launches "
                             f"{launches}, plain versions {dict(plain)}")
    profile_seen("forward", lambda: perplexity(model, ids),
                 tag="profile-lm-loglik")
    return {"chunked_scan_fwd": model.n_layer * (1 + batches)}


def card_against_cpu_mir_step():
    """One MIR fine-tuning step at full width (CLIP-TimeMamba-B, 2 clips of
    16 × 224² and 2 captions of 77 tokens) and depth
    ``CARD_CPU_MIR_DEPTH`` + ``CARD_CPU_MIR_DEPTH``, fp32, TF32 off: the
    card through K1, K10 and K2 against the CPU through the plain
    versions; the loss and every parameter's gradient."""
    import torch
    from video_mamba_suite_torch import MirFinetuner, build_clip_mir
    from video_mamba_suite_torch.configs import CLIP_TIMEMAMBA_B_EK100_MIR
    from video_mamba_suite_torch.ops import LAUNCHES, reset_launches

    set_tf32(False)
    m = CLIP_TIMEMAMBA_B_EK100_MIR["model"]
    config = dict(CLIP_TIMEMAMBA_B_EK100_MIR, model=dict(
        m, vision_cfg=dict(m["vision_cfg"], depth=CARD_CPU_MIR_DEPTH),
        text_cfg=dict(m["text_cfg"], layers=CARD_CPU_MIR_DEPTH)))
    cpu = build_clip_mir(config, device="cpu", seed=6, attn_flash="row",
                         warmup_steps=0)
    card = MirFinetuner(copy.deepcopy(cpu.model).to("cuda"),
                        **dict(config["opt"], seed=6, warmup_steps=0))
    clips, ids = mir_inputs(2, 2, seed=35)
    t0 = time.perf_counter()
    reset_launches()
    got = card.train_step(clips, ids)
    launches = dict(LAUNCHES)
    want = cpu.train_step(clips.cpu(), ids.cpu())
    if launches != {k: CARD_CPU_MIR_DEPTH for k in CLIP_STEP_LAUNCHES}:
        raise AssertionError(f"the card's MIR step launched {launches}")
    loss_err = abs(got - want) / abs(want)
    worst, worst_name = 0.0, ""
    cpu_params = dict(cpu.model.named_parameters())
    for name, p in card.model.named_parameters():
        w = cpu_params[name].grad
        rel = ((p.grad.cpu() - w).abs().max()
               / w.abs().max().clamp_min(1e-30)).item()
        if rel >= worst:
            worst, worst_name = rel, name
    log(f"[card-vs-cpu] MIR step fp32, full width, depth "
        f"{CARD_CPU_MIR_DEPTH} + {CARD_CPU_MIR_DEPTH}, TF32 off: loss "
        f"{got:.6f} against {want:.6f} (rel {loss_err:.3e}, tol "
        f"{CARD_CPU_MIR_REL_TOL}); largest gradient difference over the CPU "
        f"gradient's scale {worst:.3e} ({worst_name}; tol "
        f"{CARD_CPU_MIR_GRAD_REL_TOL}) over {len(cpu_params)} parameters in "
        f"{time.perf_counter() - t0:.1f} s")
    if not loss_err <= CARD_CPU_MIR_REL_TOL or \
            not worst <= CARD_CPU_MIR_GRAD_REL_TOL:
        raise AssertionError("card and CPU MIR steps disagree")


def card_against_cpu_lm_int8():
    """The int8 Mamba-130M (``quantize_lm_for_decode``, bf16 activations)
    at full width and depth, batch 2: the card through K5 (prompt 16) and
    K3 (prompt 80) against the CPU through the plain versions; the forward
    logits, the prefill's and 4 decode steps' fed the same tokens."""
    import torch
    from video_mamba_suite_torch import build_mamba_lm, quantize_lm_for_decode
    from video_mamba_suite_torch.configs import MAMBA_130M
    from video_mamba_suite_torch.ops import LAUNCHES, reset_launches

    cpu = quantize_lm_for_decode(build_mamba_lm(MAMBA_130M, device="cpu",
                                                seed=2))
    card = copy.deepcopy(cpu).to("cuda")
    t0 = time.perf_counter()

    def rel(got, want):
        return ((got.float().cpu() - want.float()).abs().max()
                / want.float().abs().max()).item()

    worst = {}
    for prompt, kernel in ((LM_PROMPT, "short_scan_fwd"),
                           (80, "chunked_scan_fwd")):
        ids = lm_prompt(cpu, 2, prompt, seed=40 + prompt, device="cpu")
        feed = lm_prompt(cpu, 2, 4, seed=41 + prompt, device="cpu")
        reset_launches()
        with torch.inference_mode():
            got = card(ids.cuda())
            torch.cuda.synchronize()
            launches = dict(LAUNCHES)
            errs = {"logits": rel(got, cpu(ids))}
            got, states = card.prefill(ids.cuda())
            want, want_states = cpu.prefill(ids)
            errs["prefill"] = rel(got, want)
            step = 0.0
            for t in range(feed.shape[1]):
                got, states = card.step(feed[:, t].cuda(), states)
                want, want_states = cpu.step(feed[:, t], want_states)
                step = max(step, rel(got, want))
            errs["decode"] = step
        log(f"[card-vs-cpu] int8 Mamba-130M, depth {cpu.n_layer}, batch 2, "
            f"prompt {prompt} ({kernel}): largest logit difference over the "
            f"CPU logits' scale: " + ", ".join(
                f"{k} {v:.3e}" for k, v in errs.items())
            + f" (tol {CARD_CPU_W8_REL_TOL}); card launches {launches}")
        if launches != {kernel: cpu.n_layer}:
            raise AssertionError(f"the card's int8 forward at {prompt} "
                                 f"launched {launches}")
        worst.update({f"{k} at {prompt}": v for k, v in errs.items()})
    log(f"[card-vs-cpu] int8 Mamba-130M done in "
        f"{time.perf_counter() - t0:.1f} s")
    if not all(math.isfinite(v) and v <= CARD_CPU_W8_REL_TOL
               for v in worst.values()):
        raise AssertionError(f"card and CPU int8 LM disagree: {worst}")


# ---------------------------------------------------------------------------
# temporal action segmentation (ASFormer-Mamba) and upstream checkpoints


def tas_video(config, length, videos, seed):
    """``videos`` synthetic videos of ``length`` features at the
    configuration's width and classes (items of ``make_synthetic_dataset``:
    (features (C, L), labels))."""
    from video_mamba_suite_torch.tasks.tas import make_synthetic_dataset

    return make_synthetic_dataset(
        videos, config["dataset"]["num_classes"],
        config["model"]["input_dim"], length, length + 1, seed=seed)


def tas_evaluate(tag, trainer, config, length):
    """``TasTrainer.evaluate`` over ``TAS_EVAL_VIDEOS[tag]`` synthetic videos
    of ``length`` features (one forward a video: 20 K3 without checkpoints,
    no plain version), ms a video (the forward, the labels to the host and
    the metrics) and the frame accuracy, edit score and F1@{10,25,50} (no
    target: random weights, synthetic data). Returns the launches."""
    import torch
    from video_mamba_suite_torch.ops import LAUNCHES, reset_launches
    from video_mamba_suite_torch.tasks.tas import collate

    items = tas_video(config, length, TAS_EVAL_VIDEOS[tag], seed=52)
    feats, _, mask = (torch.as_tensor(a).cuda() for a in collate(items[:1]))
    trainer.predict(feats, mask)                              # warm-up
    torch.cuda.synchronize()
    reset_launches()
    with count_plain_calls() as plain, count_checkpoint_writes() as ck:
        t0 = time.perf_counter()
        scores = trainer.evaluate(items)
        seconds = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    want = {"chunked_scan_fwd": 2 * TAS_LAYERS * len(items)}
    writes = ck["chunked_scan_fwd with checkpoints"]
    log(f"[{tag}] evaluate over {len(items)} synthetic videos of {length} "
        f"features on {card_line()}: {1e3 * seconds / len(items):.2f} "
        f"ms/video; " + ", ".join(f"{k} {v:.2f}" for k, v in scores.items())
        + f" (random weights: no target); launches {launches}")
    if launches != want or writes or sum(plain.values()) or \
            set(scores) != {"acc", "edit", "F1@10", "F1@25", "F1@50"} or \
            not all(0 <= v <= 100 for v in scores.values()):
        raise AssertionError(f"{tag} evaluate: {scores}, launches "
                             f"{launches} (want {want}), checkpoint writes "
                             f"{writes}, plain versions {dict(plain)}")
    profile_seen("video", lambda: trainer.predict(feats, mask),
                 tag=f"profile-{tag}-eval")
    return launches


def run_tas(tag, config, length, steps):
    """ASFormer-Mamba at a preset's full widths (``build_tas_trainer``:
    2048-d features, 10 masked ViM encoder layers at d_model 64, 3
    decoders of 10 layers, dropout 0.5 and drop-path 0.3 from the
    trainer's generator on the card, Adam with L2; fp32) on one synthetic
    video of ``length`` features staged on the card once: 2 warm-ups
    (every parameter a finite gradient), then ``steps`` timed
    ``train_step`` calls with exactly 20 K3 (writing checkpoints) and 20
    K4 each and no plain version; ms/step, peak memory, a profile window
    (busy share); then ``tas_evaluate``. Returns the launches."""
    import torch
    from video_mamba_suite_torch import build_tas_trainer
    from video_mamba_suite_torch.tasks.tas import collate

    t0 = time.perf_counter()
    trainer = build_tas_trainer(config, seed=0)
    batch = [torch.as_tensor(a).cuda() for a in
             collate(tas_video(config, length, 1, seed=50))]
    log(f"[{tag}] built and staged in {time.perf_counter() - t0:.1f} s: "
        f"{sum(p.numel() for p in trainer.model.parameters()) / 1e6:.3f} M "
        f"parameters, one video of {length} x "
        f"{config['model']['input_dim']} features, "
        f"{config['dataset']['num_classes']} classes")
    launches = train_phase(tag, trainer, batch, steps, TAS_STEP_LAUNCHES, 1)
    for kernel, count in tas_evaluate(tag, trainer, config, length).items():
        launches[kernel] = launches.get(kernel, 0) + count
    return launches


def run_tas_gtea():
    """ASFormer-Mamba on GTEA (``configs.TAS_GTEA``, 11 classes): a video
    of 1500 features."""
    from video_mamba_suite_torch.configs import TAS_GTEA

    return run_tas("tas-gtea", TAS_GTEA, TAS_GTEA_LENGTH, TAS_STEPS)


def run_tas_50salads():
    """ASFormer-Mamba on 50Salads (``configs.TAS_50SALADS``, 19 classes):
    a video of 6000 features, the length of a 12000-frame video after the
    preset's sample rate 2."""
    from video_mamba_suite_torch.configs import TAS_50SALADS

    return run_tas("tas-50salads", TAS_50SALADS, TAS_50SALADS_LENGTH,
                   TAS_STEPS)


def upstream_vim_shapes(prefix, d_model, expand):
    """Upstream bimamba-v2 mixer keys and shapes (d_state 16, conv 4)."""
    d_in, rank = d_model * expand, math.ceil(d_model / 16)
    shapes = {"in_proj.weight": (2 * d_in, d_model),
              "out_proj.weight": (d_model, d_in)}
    for suf, a_log, d in (("", "A_log", "D"), ("_b", "A_b_log", "D_b")):
        shapes.update({f"conv1d{suf}.weight": (d_in, 1, 4),
                       f"conv1d{suf}.bias": (d_in,),
                       f"x_proj{suf}.weight": (rank + 32, d_in),
                       f"dt_proj{suf}.weight": (d_in, rank),
                       f"dt_proj{suf}.bias": (d_in,),
                       a_log: (d_in, 16), d: (d_in,)})
    return {prefix + k: v for k, v in shapes.items()}


def upstream_ln(name, d):
    return {name + ".weight": (d,), name + ".bias": (d,)}


def upstream_attn_mlp(prefix, d, fc1, fc2):
    """nn.MultiheadAttention and a 4x MLP."""
    return {prefix + k: v for k, v in {
        "attn.in_proj_weight": (3 * d, d), "attn.in_proj_bias": (3 * d,),
        "attn.out_proj.weight": (d, d), "attn.out_proj.bias": (d,),
        f"mlp.{fc1}.weight": (4 * d, d), f"mlp.{fc1}.bias": (4 * d,),
        f"mlp.{fc2}.weight": (d, 4 * d), f"mlp.{fc2}.bias": (d,)}.items()}


def upstream_clip_shapes(model_cfg):
    """The keys and shapes of an upstream avion CLIP-TimeMamba checkpoint at
    ``model_cfg``'s widths (timemamba.py with ln_pre, no patch bias, tanh
    gates; open_clip's text tower)."""
    v, t = model_cfg["vision_cfg"], model_cfg["text_cfg"]
    d, p, out = v["embed_dim"], v["patch_size"], model_cfg["embed_dim"]
    n = (v["img_size"] // p) ** 2
    shapes = {"visual.patch_embed.proj.weight": (d, 3, p, p),
              "visual.cls_token": (1, 1, d), "visual.pos_embed": (1, n + 1, d),
              "visual.image_projection": (d, out),
              **upstream_ln("visual.ln_pre", d), **upstream_ln("visual.norm", d),
              "logit_scale": ()}
    for i in range(v["depth"]):
        b = f"visual.blocks.{i}."
        for norm in ("norm1", "norm2", "norm3"):
            shapes.update(upstream_ln(b + norm, d))
        shapes.update(upstream_attn_mlp(b, d, "fc1", "fc2"))
        shapes.update(upstream_vim_shapes(b + "time_mamba.", d, 1))
        shapes[b + "alpha_timeattn"] = ()
    w = t["width"]
    shapes.update({"textual.token_embedding.weight": (t["vocab_size"], w),
                   "textual.positional_embedding": (t["context_length"], w),
                   "textual.text_projection": (w, out),
                   **upstream_ln("textual.ln_final", w)})
    for i in range(t["layers"]):
        b = f"textual.transformer.resblocks.{i}."
        shapes.update(upstream_ln(b + "ln_1", w))
        shapes.update(upstream_ln(b + "ln_2", w))
        shapes.update(upstream_attn_mlp(b, w, "c_fc", "c_proj"))
    return shapes


def upstream_vivim_shapes(cfg, frames):
    """The keys and shapes of an upstream ViViM checkpoint at ``cfg``'s
    widths whose temporal embedding holds ``frames`` rows."""
    d, p = cfg["embed_dim"], cfg["patch_size"]
    n = (cfg["img_size"] // p) ** 2
    shapes = {"patch_embed.proj.weight": (d, 3, p, p),
              "patch_embed.proj.bias": (d,), "cls_token": (1, 1, d),
              "pos_embed": (1, n + 1, d), "temporal_embedding": (frames, 1, d),
              **upstream_ln("norm_f", d),
              "head.weight": (cfg["num_classes"], d),
              "head.bias": (cfg["num_classes"],)}
    for i in range(cfg["depth"]):
        shapes.update(upstream_ln(f"layers.{i}.norm", d))
        shapes.update(upstream_vim_shapes(f"layers.{i}.mixer.", d, 2))
    return shapes


def upstream_state_dict(shapes, seed):
    """fp32 CPU tensors for ``shapes`` from a generator seeded with
    ``seed``, in the ranges upstream's inits give: weights N(0, 0.02²),
    A_log = log(1..16), dt biases the inverse softplus of U(0.001, 0.1), D
    and norm weights 1, biases 0, tanh gates 0.5, the CLIP scale log(1 /
    0.07)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    sd = {}
    for name, shape in shapes.items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("A_log", "A_b_log"):
            t = torch.log(torch.arange(1, shape[-1] + 1,
                                       dtype=torch.float32)).repeat(
                                           shape[0], 1)
        elif name.endswith("dt_proj.bias") or name.endswith("dt_proj_b.bias"):
            dt = 0.001 + 0.099 * torch.rand(shape, generator=g)
            t = dt + torch.log(-torch.expm1(-dt))
        elif leaf in ("D", "D_b") or (len(shape) == 1 and leaf == "weight"
                                      and "proj" not in name
                                      and "conv" not in name):
            t = torch.ones(shape)
        elif leaf == "bias" and ("norm" in name or "ln_" in name):
            t = torch.zeros(shape)
        elif leaf == "alpha_timeattn":
            t = torch.full(shape, 0.5)
        elif leaf == "logit_scale":
            t = torch.tensor(math.log(1 / 0.07))
        else:
            t = 0.02 * torch.randn(shape, generator=g)
        sd[name] = t
    return sd


def run_ckpt_mir():
    """Upstream checkpoints into the towers on the card: an upstream-layout
    CLIP-TimeMamba-B state dict at the ego_ek100_mir widths (drawn from
    ``CKPT_SEED``) saved beside an ``argparse.Namespace`` and an epoch,
    read back by ``load_state_dict`` (weights only), converted by
    ``clip_from_state_dict`` and loaded with ``strict=True`` into
    ``build_clip_mir``'s model (bf16 video tower on K10); one MIR request
    of 8 clips and 8 captions: exactly 12 K1 and 12 K10. Then an upstream
    ViViM-T K400 state dict with an 8-frame temporal embedding, inflated
    to 16 frames by ``inflate_temporal_embed``, through
    ``vivim_from_state_dict`` into ``build_vivim_tiny_k400``'s model; one
    recognition request of 8 clips: exactly 48 K3. Returns the
    launches."""
    import argparse
    import os
    import tempfile

    import torch
    from video_mamba_suite_torch import build_clip_mir, build_vivim_tiny_k400
    from video_mamba_suite_torch.configs import (
        CLIP_TIMEMAMBA_B_EK100_MIR,
        VIVIM_T_K400,
    )
    from video_mamba_suite_torch.models import (
        clip_from_state_dict,
        inflate_temporal_embed,
        load_state_dict,
        vivim_from_state_dict,
    )
    from video_mamba_suite_torch.models.convert import patch_weight
    from video_mamba_suite_torch.ops import LAUNCHES, reset_launches
    from video_mamba_suite_torch.tasks.recognition import predict

    m = CLIP_TIMEMAMBA_B_EK100_MIR["model"]
    model = build_clip_mir(attn_flash="row", vision_dtype=torch.bfloat16,
                           seed=0).model
    t0 = time.perf_counter()
    sd = upstream_state_dict(upstream_clip_shapes(m), CKPT_SEED)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "clip_timemamba_b_mir.pth")
        torch.save({"state_dict": sd, "epoch": 0, "args": argparse.Namespace(
            model="CLIP_TimeMamba_B", lr=1e-5, clip_length=16)}, path)
        size = os.path.getsize(path)
        t1 = time.perf_counter()
        loaded = load_state_dict(path)
        t_load = time.perf_counter() - t1
    converted = clip_from_state_dict(loaded, "timemamba",
                                     m["vision_cfg"]["depth"],
                                     m["text_cfg"]["layers"])
    model.load_state_dict(converted, strict=True)
    if not torch.equal(model.visual.patch_embed.weight.cpu(), patch_weight(
            sd["visual.patch_embed.proj.weight"])):
        raise AssertionError("the loaded patch embedding is not the "
                             "checkpoint's")
    log(f"[ckpt-mir] CLIP-TimeMamba-B upstream state dict: {len(sd)} "
        f"tensors, {size / 1e6:.1f} MB with its argparse.Namespace; "
        f"load_state_dict {t_load:.2f} s, drawn, saved, read and converted "
        f"in {time.perf_counter() - t0:.1f} s; {len(converted)} port "
        f"tensors loaded strictly")
    clips, ids = mir_inputs(BATCH, MIR_CAPTIONS, seed=36)
    reset_launches()
    with torch.inference_mode(), count_plain_calls() as plain:
        t0 = time.perf_counter()
        img, txt, scale = model(clips, ids)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
    launches = dict(LAUNCHES)
    want = {"short_bidir_fwd": 12, "row_mha_fwd": 12}
    log(f"[ckpt-mir] one MIR request on the loaded weights: {ms:.2f} ms "
        f"(first request), scale {scale.item():.4f}, launches {launches}")
    if launches != want or sum(plain.values()) or \
            not (torch.isfinite(img).all() and torch.isfinite(txt).all()) \
            or abs(scale.item() - 1 / 0.07) > 1e-3:
        raise AssertionError(f"ckpt-mir MIR request: launches {launches} "
                             f"(want {want}), plain {dict(plain)}, scale "
                             f"{scale.item()}")
    del model, sd, loaded, converted

    set_tf32(True)
    vivim = build_vivim_tiny_k400(seed=0)
    sd = upstream_state_dict(upstream_vivim_shapes(
        VIVIM_T_K400, CKPT_VIVIM_FRAMES), CKPT_SEED + 1)
    short = sd["temporal_embedding"]
    sd["temporal_embedding"] = inflate_temporal_embed(
        short, VIVIM_T_K400["num_frames"], "bilinear")
    vivim.load_state_dict(vivim_from_state_dict(sd, VIVIM_T_K400["depth"]),
                          strict=True)
    x = vivim_clips(BATCH, seed=37)
    reset_launches()
    with count_plain_calls() as plain:
        probs = predict(vivim, x)
        torch.cuda.synchronize()
    vivim_launches = dict(LAUNCHES)
    log(f"[ckpt-mir] ViViM-T K400 from an upstream state dict, temporal "
        f"embedding {tuple(short.shape)} inflated to "
        f"{tuple(sd['temporal_embedding'].shape)}: one request of {BATCH} "
        f"clips, probabilities {tuple(probs.shape)}, launches "
        f"{vivim_launches}")
    if vivim_launches != {"chunked_scan_fwd": VIVIM_LAUNCHES} or \
            sum(plain.values()) or not torch.isfinite(probs).all():
        raise AssertionError(f"ckpt-mir ViViM-T request launched "
                             f"{vivim_launches}, plain {dict(plain)}")
    launches.update(vivim_launches)
    return launches


def card_against_cpu_tas():
    """One ASFormer-Mamba ``train_step`` with dropout off
    (``deterministic=True``) at full width (``TAS_GTEA``: 2048-d features,
    64 maps, 11 classes), ``CARD_CPU_TAS_DEPTH`` layers and one decoder,
    on a synthetic video of ``CARD_CPU_TAS_LENGTH`` features, fp32 with
    TF32 off: the card through K3 and K4 against the CPU through the
    plain versions; the loss and every parameter's gradient."""
    import torch
    from video_mamba_suite_torch import build_tas_trainer
    from video_mamba_suite_torch.configs import TAS_GTEA
    from video_mamba_suite_torch.ops import LAUNCHES, reset_launches
    from video_mamba_suite_torch.tasks.tas import collate

    set_tf32(False)
    kw = dict(num_layers=CARD_CPU_TAS_DEPTH, num_decoders=1, seed=7)
    cpu = build_tas_trainer(TAS_GTEA, device="cpu", **kw)
    card = build_tas_trainer(TAS_GTEA, **kw)
    batch = collate(tas_video(TAS_GTEA, CARD_CPU_TAS_LENGTH, 1, seed=51))
    t0 = time.perf_counter()
    reset_launches()
    got = card.train_step(*batch, deterministic=True)
    launches = dict(LAUNCHES)
    want = cpu.train_step(*batch, deterministic=True)
    loss_err = abs(got - want) / abs(want)
    cpu_grads = {n: p.grad for n, p in cpu.model.named_parameters()}
    floor = CARD_CPU_TAS_GRAD_FLOOR * max(
        g.abs().max().item() for g in cpu_grads.values())
    worst, worst_name, missing = 0.0, "", []
    for name, p in card.model.named_parameters():
        w = cpu_grads[name]
        if p.grad is None or not torch.isfinite(p.grad).all():
            missing.append(name)
            continue
        rel = ((p.grad.cpu() - w).abs().max()
               / max(w.abs().max().item(), floor)).item()
        if rel >= worst:
            worst, worst_name = rel, name
    log(f"[card-vs-cpu] ASFormer-Mamba step fp32, full width, depth "
        f"{CARD_CPU_TAS_DEPTH}, 1 decoder, {CARD_CPU_TAS_LENGTH} steps, "
        f"TF32 off, dropout off: loss {got:.6f} against {want:.6f} (rel "
        f"{loss_err:.3e}, tol {CARD_CPU_TAS_REL_TOL}); largest gradient "
        f"difference over the CPU gradient's scale (floor "
        f"{CARD_CPU_TAS_GRAD_FLOOR} of the largest) {worst:.3e} "
        f"({worst_name}; tol {CARD_CPU_TAS_GRAD_REL_TOL}) over "
        f"{len(cpu_grads)} parameters; card launches {launches}; "
        f"{time.perf_counter() - t0:.1f} s")
    steps = 2 * CARD_CPU_TAS_DEPTH
    if launches != {"chunked_scan_fwd": steps, "chunked_scan_bwd": steps}:
        raise AssertionError(f"the card's TAS step launched {launches}")
    if missing or not loss_err <= CARD_CPU_TAS_REL_TOL or \
            not worst <= CARD_CPU_TAS_GRAD_REL_TOL:
        raise AssertionError(f"card and CPU TAS steps disagree (no or "
                             f"non-finite gradient: {missing})")


# ---------------------------------------------------------------------------
# video temporal grounding (UniVTG-Mamba): moment retrieval, highlight
# detection, VLP zero-shot scores and QFVS


def vtg_samples(config, n, seed):
    """``n`` synthetic moment-retrieval samples at a preset's widths and
    padding (``make_synthetic_vtg``: the query planted in its window):
    ``VTG_QUERY_TOKENS`` query tokens, the preset's clips of
    ``clip_len`` seconds."""
    from video_mamba_suite_torch.tasks.vtg import make_synthetic_vtg

    m, d = config["model"], config["dataset"]
    return make_synthetic_vtg(
        num_samples=n, ctx_l=m["max_v_l"], txt_len=VTG_QUERY_TOKENS,
        txt_dim=d["t_feat_dim"], vid_dim=d["v_feat_dim"],
        clip_len=m["clip_len"], seed=seed)


def on_card(batch):
    """A batch dict of numpy arrays staged on the card once."""
    import torch

    return {k: torch.as_tensor(v).cuda() for k, v in batch.items()}


def loss_total_steps(trainer):
    """``trainer`` as ``train_phase`` drives it: its ``train_step``
    returning the total loss alone."""
    return types.SimpleNamespace(
        model=trainer.model,
        train_step=lambda *a: trainer.train_step(*a)["loss_total"])


def forward_launches(tag, fn, want, repeat):
    """``repeat`` calls of ``fn`` after one warm-up, timed one by one, with
    exactly ``want`` launches a call, no checkpoint and no plain version.
    Returns (sorted seconds, the result of the last call, the
    launches)."""
    import torch
    from video_mamba_suite_torch.ops import LAUNCHES, reset_launches

    fn()
    torch.cuda.synchronize()
    reset_launches()
    times = []
    with count_plain_calls() as plain, count_checkpoint_writes() as ck:
        for _ in range(repeat):
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    launches = dict(LAUNCHES)
    want_all = {k: v * repeat for k, v in want.items()}
    writes = ck["chunked_scan_fwd with checkpoints"]
    if launches != want_all or writes or sum(plain.values()):
        raise AssertionError(f"{tag} launched {launches} in {repeat} calls "
                             f"(want {want_all}), checkpoint writes "
                             f"{writes}, plain versions {dict(plain)}")
    return sorted(times), out, launches


def run_vtg_qvhl():
    """UniVTG-Mamba on QVHighlights at the preset's full widths
    (``build_vtg_trainer(configs.VTG_QVHIGHLIGHTS)``: 512-d query and
    2816-d clip features projected to 1024, 6 DBM layers, input dropout
    0.5 and drop-path 0.1 from the trainer's generator on the card,
    AdamW with clip 0.1; fp32, TF32 off in the matmuls and cuDNN's
    convolutions) on a batch of 32 synthetic samples padded
    to 32 + 75 steps, staged on the card once: 2 warm-ups, then
    ``VTG_STEPS`` timed steps with exactly 12 K3 (writing checkpoints)
    and 12 K4 each, no plain version; ms/step, peak memory, a profile
    window (busy share). Then ``predict`` of 8 samples (12 K3, no
    checkpoints) timed, and ``evaluate`` over ``VTG_EVAL_SAMPLES``: its
    mAP, mIoU, R1 and HL metrics (random weights: no target). Returns the
    launches."""
    import torch
    from video_mamba_suite_torch import build_vtg_trainer
    from video_mamba_suite_torch.configs import VTG_QVHIGHLIGHTS
    from video_mamba_suite_torch.tasks.vtg import collate_vtg

    config = VTG_QVHIGHLIGHTS
    set_tf32(False)
    t0 = time.perf_counter()
    trainer = build_vtg_trainer(config, seed=0)
    bs = config["loader"]["batch_size"]
    batch = on_card(collate_vtg(vtg_samples(config, bs, seed=60),
                                trainer.max_q_l, trainer.max_v_l))
    log(f"[vtg-qvhl] built and staged in {time.perf_counter() - t0:.1f} s: "
        f"{sum(p.numel() for p in trainer.model.parameters()) / 1e6:.3f} M "
        f"parameters; a batch of {bs} x ({trainer.max_q_l} query + "
        f"{trainer.max_v_l} clip steps), {config['dataset']['t_feat_dim']}"
        f"-d text, {config['dataset']['v_feat_dim']}-d video")
    launches = train_phase("vtg-qvhl", loss_total_steps(trainer), (batch,),
                           VTG_STEPS, VTG_STEP_LAUNCHES, bs)
    log(f"[vtg-qvhl] last step's losses: " + ", ".join(
        f"{k} {v:.5f}" for k, v in trainer.train_step(batch).items()))
    samples = vtg_samples(config, VTG_EVAL_SAMPLES, seed=61)
    want = {"chunked_scan_fwd": 2 * VTG_LAYERS}
    times, _, fwd = forward_launches(
        "vtg-qvhl predict", lambda: trainer.predict(samples[:8]), want,
        VTG_PREDICTS)
    log(f"[vtg-qvhl] predict of 8 samples on {card_line()}: median "
        f"{1e3 * statistics.median(times):.2f} ms (min "
        f"{1e3 * times[0]:.2f}, max {1e3 * times[-1]:.2f}); launches {fwd}")
    batches = -(-len(samples) // 8)
    times, scores, ev = forward_launches(
        "vtg-qvhl evaluate", lambda: trainer.evaluate(samples),
        {k: v * batches for k, v in want.items()}, 1)
    log(f"[vtg-qvhl] evaluate over {len(samples)} synthetic samples: "
        f"{1e3 * times[0]:.2f} ms; " + ", ".join(
            f"{k} {v:.2f}" for k, v in scores.items())
        + " (random weights: no target)")
    if set(scores) != {"mAP_avg", "mIoU@1", "R1@0.5", "R1@0.7", "HL_hit1",
                       "HL_mAP"} or \
            not all(0 <= v <= 100 for v in scores.values()):
        raise AssertionError(f"vtg-qvhl evaluate: {scores}")
    profile_seen("batch", lambda: trainer.predict(samples[:8]),
                 tag="profile-vtg-qvhl-predict")
    for counts in (fwd, ev):
        for kernel, count in counts.items():
            launches[kernel] = launches.get(kernel, 0) + count
    return launches


def tvsum_videos(n, length, vid_dim, seed):
    """``n`` synthetic highlight videos (the JAX CLI's synthetic TVSum
    items at the preset's widths): features with a planted segment of
    higher saliency, 20 annotators' scores of 0-2 (3-5 in the segment),
    the saliency their sum above its median."""
    import numpy as np

    rng = np.random.default_rng(seed)
    videos = []
    for _ in range(n):
        feat = 0.1 * rng.standard_normal((length, vid_dim)).astype(
            np.float32)
        anno = rng.integers(0, 3, (length, TVSUM_ANNOTATORS)).astype(
            np.float32)
        s = int(rng.integers(0, length - 64))
        feat[s:s + 64] += 1.0
        anno[s:s + 64] += 3.0
        agg = anno.sum(1)
        videos.append(dict(vid_feat=feat, anno=anno, saliency=(
            agg > np.median(agg)).astype(np.float32)))
    return videos


def run_vtg_tvsum():
    """Highlight detection on TVSum at the preset's widths
    (``build_hl_trainer(configs.VTG_TVSUM)``: no query (one zero text
    token), 2816-d features of up to 512 clips, 6 DBM layers of width
    1024; fp32, TF32 off): 2 warm-ups, then ``VTG_STEPS`` timed steps of 4 videos
    x (1 + 512) steps with exactly 12 K3 (writing checkpoints) and 12 K4
    each; then ``predict_scores`` of one video timed (12 K3 a video) and
    the top-5 mAP over ``TVSUM_EVAL_VIDEOS`` synthetic videos and 20
    annotators (random weights: no target). Returns the launches."""
    from video_mamba_suite_torch import build_hl_trainer
    from video_mamba_suite_torch.configs import VTG_TVSUM
    from video_mamba_suite_torch.tasks.vtg import collate_hl, tvsum_map_at_k

    config = VTG_TVSUM
    set_tf32(False)
    t0 = time.perf_counter()
    trainer = build_hl_trainer(config, seed=0)
    bs, L = config["loader"]["batch_size"], trainer.max_v_l
    vid_dim = config["dataset"]["v_feat_dim"]
    batch = on_card(collate_hl(tvsum_videos(bs, L, vid_dim, seed=62), L,
                               trainer.txt_dim))
    log(f"[vtg-tvsum] built and staged in {time.perf_counter() - t0:.1f} "
        f"s: a batch of {bs} videos x (1 + {L}) steps, {vid_dim}-d video")
    launches = train_phase("vtg-tvsum", loss_total_steps(trainer), (batch,),
                           VTG_STEPS, VTG_STEP_LAUNCHES, bs)
    videos = tvsum_videos(TVSUM_EVAL_VIDEOS, L, vid_dim, seed=63)
    want = {"chunked_scan_fwd": 2 * VTG_LAYERS}
    times, _, fwd = forward_launches(
        "vtg-tvsum predict_scores", lambda: trainer.predict_scores(
            videos[:1]), want, VTG_PREDICTS)
    scores = trainer.predict_scores(videos)
    m5 = tvsum_map_at_k(scores, [v["anno"] for v in videos], k=5)
    log(f"[vtg-tvsum] predict_scores of one video of {L} clips on "
        f"{card_line()}: median {1e3 * statistics.median(times):.2f} ms "
        f"(min {1e3 * times[0]:.2f}, max {1e3 * times[-1]:.2f}); launches "
        f"{fwd}; top-5 mAP over {len(videos)} synthetic videos and "
        f"{TVSUM_ANNOTATORS} annotators {100 * m5:.2f} (random weights: no "
        f"target)")
    if not 0 <= m5 <= 1:
        raise AssertionError(f"vtg-tvsum: top-5 mAP {m5}")
    for kernel, count in fwd.items():
        launches[kernel] = launches.get(kernel, 0) + count
    return launches


def run_vtg_vlp_qfvs():
    """VLP zero-shot class scores and QFVS at the QVHighlights model widths
    (embed 1024, 6 layers; 512-d text, 2816-d video; no preset gives QFVS
    widths; fp32, TF32 off). ``VlpPretrainer.zero_shot_class_scores`` of
    8 synthetic VLP
    samples (point, interval and curve; 32 + 75 steps: 12 K3 a call)
    against ``VLP_CLASSES`` class names of ``VLP_CLASS_TOKENS`` tokens,
    timed. Then ``QfvsTrainer`` (its ViM mixer, no input dropout,
    drop-path 0.1 from the generator) on ``QFVS_ITEMS`` synthetic items
    of 3 segments x 8 frames: three forwards a step (concept 1, concept 2
    and the oracle: 1 or 2 query tokens + 24 frames, at most 64 steps),
    so exactly 18 K1 and 18 K2 a step; ``evaluate`` (18 K1: the three
    forwards) and its P / R / F (no target). Returns the launches."""
    import numpy as np
    from video_mamba_suite_torch.configs import VTG_QVHIGHLIGHTS
    from video_mamba_suite_torch.tasks.vtg import (
        QfvsTrainer,
        VlpPretrainer,
        collate_qfvs,
        make_synthetic_qfvs,
        make_synthetic_vlp,
        vtg_trainer_kwargs,
    )

    config = VTG_QVHIGHLIGHTS
    d, m = config["dataset"], config["model"]
    set_tf32(False)
    vlp = VlpPretrainer(**vtg_trainer_kwargs(config), seed=0)
    samples = make_synthetic_vlp(
        num_samples=8, ctx_l=m["max_v_l"], vid_dim=d["v_feat_dim"],
        txt_dim=d["t_feat_dim"], q_l=VTG_QUERY_TOKENS, seed=64)
    rng = np.random.default_rng(65)
    cls = rng.standard_normal((VLP_CLASSES, VLP_CLASS_TOKENS,
                               d["t_feat_dim"])).astype(np.float32)
    times, scores, launches = forward_launches(
        "vlp zero-shot", lambda: vlp.zero_shot_class_scores(samples, cls),
        {"chunked_scan_fwd": 2 * VTG_LAYERS}, VTG_PREDICTS)
    if scores.shape != (8, m["max_v_l"], VLP_CLASSES) or \
            not np.isfinite(scores).all() or np.abs(scores).max() > 1 + 1e-5:
        raise AssertionError(f"zero-shot scores {scores.shape}, largest "
                             f"{np.abs(scores).max()}")
    log(f"[vtg-vlp] zero_shot_class_scores of 8 samples x "
        f"{VLP_CLASSES} classes on {card_line()}: median "
        f"{1e3 * statistics.median(times):.2f} ms (min "
        f"{1e3 * times[0]:.2f}, max {1e3 * times[-1]:.2f}); launches "
        f"{launches}; scores in [{scores.min():.3f}, {scores.max():.3f}]")
    del vlp
    trainer = QfvsTrainer(txt_dim=d["t_feat_dim"], vid_dim=d["v_feat_dim"],
                          embed_dim=m["embed_dim"], depth=m["depth"], seed=0)
    items, tags = make_synthetic_qfvs(
        num_items=QFVS_ITEMS, vid_dim=d["v_feat_dim"],
        txt_dim=d["t_feat_dim"], seed=66)
    batch = collate_qfvs(items)
    log(f"[vtg-qfvs] {QFVS_ITEMS} items x {batch[0].shape[1]} frames, "
        f"{d['v_feat_dim']}-d video, concepts of {d['t_feat_dim']}")
    step = train_phase("vtg-qfvs", loss_total_steps(trainer), batch,
                       VTG_STEPS, QFVS_STEP_LAUNCHES, QFVS_ITEMS)
    times, scores, ev = forward_launches(
        "vtg-qfvs evaluate", lambda: trainer.evaluate(items, tags),
        {"short_bidir_fwd": 3 * VTG_LAYERS}, 1)
    log(f"[vtg-qfvs] evaluate over {QFVS_ITEMS} items: "
        f"{1e3 * times[0]:.2f} ms; " + ", ".join(
            f"{k} {v:.2f}" for k, v in scores.items())
        + " (random weights: no target)")
    if not all(0 <= v <= 100 for v in scores.values()):
        raise AssertionError(f"vtg-qfvs evaluate: {scores}")
    for counts in (step, ev):
        for kernel, count in counts.items():
            launches[kernel] = launches.get(kernel, 0) + count
    return launches


def _rel_err(got, want, valid=None):
    """Largest |got - want| over the largest |want| (on ``valid`` only)."""
    got, want = got.detach().float().cpu(), want.detach().float()
    if valid is not None:
        got, want = got[valid], want[valid]
    return ((got - want).abs().max() / want.abs().max()).item()


def card_against_cpu_vtg():
    """UniVTG-Mamba at the QVHighlights preset's full widths and
    ``CARD_CPU_VTG_DEPTH`` layers, fp32 with TF32 off, on
    ``CARD_CPU_VTG_BATCH`` samples of 32 + 75 steps: the card through K3
    and K4 against the CPU through the plain versions, the same weights.
    The eval forward's outputs (the saliency on valid clips), then one
    ``train_step`` with dropout off: every loss term and every
    parameter's gradient."""
    import torch
    from video_mamba_suite_torch import build_vtg_trainer
    from video_mamba_suite_torch.configs import VTG_QVHIGHLIGHTS
    from video_mamba_suite_torch.ops import LAUNCHES, reset_launches
    from video_mamba_suite_torch.tasks.vtg import collate_vtg

    set_tf32(False)
    kw = dict(depth=CARD_CPU_VTG_DEPTH, seed=9)
    cpu = build_vtg_trainer(VTG_QVHIGHLIGHTS, device="cpu", **kw)
    card = build_vtg_trainer(VTG_QVHIGHLIGHTS, **kw)
    samples = vtg_samples(VTG_QVHIGHLIGHTS, CARD_CPU_VTG_BATCH, seed=67)
    samples[1]["vid_feat"] = samples[1]["vid_feat"][:60]   # a ragged video
    batch = collate_vtg(samples, card.max_q_l, card.max_v_l)
    t0 = time.perf_counter()
    reset_launches()
    with torch.no_grad():
        got = card.forward(batch)
        torch.cuda.synchronize()
        fwd_launches = dict(LAUNCHES)
        want = cpu.forward(batch)
    valid = torch.as_tensor(batch["src_vid_mask"]) > 0
    errs = {k: _rel_err(got[k], want[k],
                        valid if k == "saliency_scores" else None)
            for k in want if k != "src_vid_mask"}
    reset_launches()
    got_losses = card.train_step(batch, deterministic=True)
    step_launches = dict(LAUNCHES)
    want_losses = cpu.train_step(batch, deterministic=True)
    loss_err = max(abs(got_losses[k] - v) / abs(v)
                   for k, v in want_losses.items())
    cpu_grads = {n: p.grad for n, p in cpu.model.named_parameters()}
    floor = CARD_CPU_VTG_GRAD_FLOOR * max(
        g.abs().max().item() for g in cpu_grads.values())
    worst, worst_name, missing = 0.0, "", []
    for name, p in card.model.named_parameters():
        w = cpu_grads[name]
        if p.grad is None or not torch.isfinite(p.grad).all():
            missing.append(name)
            continue
        rel = ((p.grad.cpu() - w).abs().max()
               / max(w.abs().max().item(), floor)).item()
        if rel >= worst:
            worst, worst_name = rel, name
    log(f"[card-vs-cpu] UniVTG-Mamba (QVHighlights widths) fp32, depth "
        f"{CARD_CPU_VTG_DEPTH}, {CARD_CPU_VTG_BATCH} x 107 steps, TF32 off: "
        f"forward, largest error over scale "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" (tol {CARD_CPU_VTG_REL_TOL}); step with dropout off: losses "
        f"within {loss_err:.3e} (tol {CARD_CPU_VTG_REL_TOL}); largest "
        f"gradient difference over the CPU gradient's scale (floor "
        f"{CARD_CPU_VTG_GRAD_FLOOR} of the largest) {worst:.3e} "
        f"({worst_name}; tol {CARD_CPU_VTG_GRAD_REL_TOL}) over "
        f"{len(cpu_grads)} parameters; card launches: forward "
        f"{fwd_launches}, step {step_launches}; "
        f"{time.perf_counter() - t0:.1f} s")
    n = 2 * CARD_CPU_VTG_DEPTH
    if fwd_launches != {"chunked_scan_fwd": n} or \
            step_launches != {"chunked_scan_fwd": n, "chunked_scan_bwd": n}:
        raise AssertionError(f"the card's UniVTG-Mamba launched "
                             f"{fwd_launches} and {step_launches}")
    if missing or not loss_err <= CARD_CPU_VTG_REL_TOL or \
            not all(e <= CARD_CPU_VTG_REL_TOL for e in errs.values()) or \
            not worst <= CARD_CPU_VTG_GRAD_REL_TOL:
        raise AssertionError(f"card and CPU UniVTG-Mamba disagree (no or "
                             f"non-finite gradient: {missing})")


def dvc_corpus(directory, videos, input_dim, seed):
    """``videos`` synthetic ActivityNet-Captions videos written into
    ``directory``: the annotation json and one .npy a video of
    ``DVC_FEATURES`` features of ``input_dim`` channels (so both the
    subsampling to 256 and the padding occur), ``DVC_EVENTS`` events each
    with a sentence of ``DVC_WORDS`` words from a corpus of
    ``DVC_CORPUS_WORDS`` words. Returns the json's path."""
    import numpy as np

    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(DVC_CORPUS_WORDS)]
    db = {}
    for v in range(videos):
        vid = f"v_{v:03d}"
        length = int(rng.integers(DVC_FEATURES[0], DVC_FEATURES[1] + 1))
        np.save(os.path.join(directory, vid + ".npy"), rng.standard_normal(
            (length, input_dim)).astype(np.float32))
        duration = float(rng.uniform(30.0, 200.0))
        stamps, sentences = [], []
        for _ in range(int(rng.integers(DVC_EVENTS[0], DVC_EVENTS[1] + 1))):
            s = float(rng.uniform(0.0, 0.8 * duration))
            stamps.append([s, float(min(duration, s + rng.uniform(
                0.05, 0.4) * duration))])
            n = int(rng.integers(DVC_WORDS[0], DVC_WORDS[1] + 1))
            sentences.append(" ".join(rng.choice(words, n)))
        db[vid] = dict(duration=duration, timestamps=stamps,
                       sentences=sentences)
    path = os.path.join(directory, "captions.json")
    with open(path, "w") as f:
        json.dump(db, f)
    return path


@contextlib.contextmanager
def timed_lsa():
    """Host seconds of each Hungarian assignment (``host_lsa``) while the
    block runs."""
    matcher = importlib.import_module(
        "video_mamba_suite_torch.tasks.captioning.matcher")
    original, seconds = matcher.host_lsa, []

    def timed(*a, **k):
        t0 = time.perf_counter()
        out = original(*a, **k)
        seconds.append(time.perf_counter() - t0)
        return out

    matcher.host_lsa = timed
    try:
        yield seconds
    finally:
        matcher.host_lsa = original


def run_dvc(tag, config):
    """PDVC-Mamba at a dense-captioning preset's full widths
    (``build_captioning_trainer``: 2 ViM layers of width 512 over the
    256 + 128 + 64 + 32 = 480 pyramid tokens; fp32, TF32 off) on the real
    data path: ``DVC_VIDEOS[tag]`` synthetic ActivityNet-Captions videos
    read by ``load_activitynet_captions`` (the vocabulary built from
    their sentences, videos subsampled to 256 features, captions of up to
    the preset's 30 tokens) and ``collate_captioning``, batch 1. 2
    warm-ups, then ``DVC_STEPS`` timed steps, each with exactly 4 K3
    (writing checkpoints) and 4 K4 and no plain version; ms/step, peak
    memory, a profile window (busy share) and the Hungarian assignment's
    host ms apart. Then ``predict`` of one video timed (4 K3, no
    checkpoints), and ``predict`` of every video with ``evaluate_dvc``,
    ``soda_c`` and ``evaluate_para`` and their host seconds (random
    weights: no target). Returns the launches."""
    import tempfile

    from video_mamba_suite_torch.tasks.captioning import (
        build_captioning_trainer,
        collate_captioning,
        evaluate_dvc,
        evaluate_para,
        load_activitynet_captions,
        soda_c,
        vocab_list,
    )

    set_tf32(False)
    model_cfg = config["model"]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as directory:
        anno = dvc_corpus(directory, DVC_VIDEOS[tag], model_cfg["input_dim"],
                          seed=70 + len(tag))
        max_seq = config.get("dataset", {}).get("max_seq_len", 256)
        items, tok = load_activitynet_captions(
            anno, directory, max_seq_len=max_seq,
            max_caption_len=model_cfg["max_caption_len"])
    trainer = build_captioning_trainer(config, tok.vocab_size, seed=0)
    model = trainer.model
    batch = collate_captioning(items[:1], trainer.max_seq_len)
    log(f"[{tag}] built in {time.perf_counter() - t0:.1f} s: "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.3f} M "
        f"parameters, {model.caption_decoder_type} caption head, vocabulary "
        f"{tok.vocab_size}; {len(items)} videos of {DVC_FEATURES[0]}-"
        f"{DVC_FEATURES[1]} features x {model_cfg['input_dim']} cut or "
        f"padded to {trainer.max_seq_len} (levels "
        f"{model.level_shapes(trainer.max_seq_len)}), "
        f"{int(batch[4].sum())} events in the step's video")
    launches = train_phase(tag, loss_total_steps(trainer), batch, DVC_STEPS,
                           DVC_STEP_LAUNCHES, 1)
    with timed_lsa() as lsa:
        for _ in range(DVC_STEPS):
            losses = trainer.train_step(*batch)
    lsa = sorted(lsa)
    log(f"[{tag}] Hungarian assignment on the host: median "
        f"{1e3 * statistics.median(lsa):.3f} ms (min {1e3 * lsa[0]:.3f}, "
        f"max {1e3 * lsa[-1]:.3f}) of a step; last losses " + ", ".join(
            f"{k} {v:.5f}" for k, v in losses.items()))
    vocab = vocab_list(tok)
    one = items[0]
    feats, mask = collate_captioning([one], trainer.max_seq_len)[:2]
    want = {"chunked_scan_fwd": 2 * DVC_ENCODER_LAYERS}
    times, events, fwd = forward_launches(
        f"{tag} predict", lambda: trainer.predict(
            feats, mask, one["duration"], vocab=vocab), want, DVC_PREDICTS)
    log(f"[{tag}] predict of one video ({model.max_caption_len}-token "
        f"greedy captions of {model.query_embed.shape[0]} queries) on "
        f"{card_line()}: median {1e3 * statistics.median(times):.2f} ms "
        f"(min {1e3 * times[0]:.2f}, max {1e3 * times[-1]:.2f}); launches "
        f"{fwd}; first event {events[0][0]}")
    profile_seen("predict", lambda: trainer.predict(
        feats, mask, one["duration"], vocab=vocab),
        tag=f"profile-{tag}-predict")

    def predict_all():
        preds = {}
        for it in items:
            f, m = collate_captioning([it], trainer.max_seq_len)[:2]
            preds[it["video_id"]] = trainer.predict(f, m, it["duration"],
                                                    vocab=vocab)[0]
        return preds

    times, preds, ev = forward_launches(
        f"{tag} predict all", predict_all,
        {k: v * len(items) for k, v in want.items()}, 1)
    gts = {it["video_id"]: it["gt_events"] for it in items}
    para = {v: ". ".join(e["sentence"] for e in g) for v, g in gts.items()}
    scores = {}
    for name, fn in (("evaluate_dvc", lambda: evaluate_dvc(preds, gts)),
                     ("soda_c", lambda: {"SODA_c": soda_c(preds, gts)}),
                     ("evaluate_para", lambda: evaluate_para(preds, para))):
        t0 = time.perf_counter()
        result = fn()
        log(f"[{tag}] {name} over {len(items)} videos: "
            f"{time.perf_counter() - t0:.3f} s on the host; " + ", ".join(
                f"{k} {v:.4f}" for k, v in result.items())
            + " (random weights: no target)")
        scores.update({f"{name}:{k}": v for k, v in result.items()})
    if not all(math.isfinite(v) for v in scores.values()) or \
            len(preds) != len(items):
        raise AssertionError(f"{tag} evaluate: {scores}")
    log(f"[{tag}] predict of {len(items)} videos one by one: "
        f"{1e3 * times[0]:.2f} ms; launches {ev}")
    for counts in (fwd, ev):
        for kernel, count in counts.items():
            launches[kernel] = launches.get(kernel, 0) + count
    return launches


def run_dvc_anet():
    from video_mamba_suite_torch.configs import DVC_ANET_C3D

    return run_dvc("dvc-anet", DVC_ANET_C3D)


def run_dvc_yc2():
    from video_mamba_suite_torch.configs import DVC_YC2_TSN

    return run_dvc("dvc-yc2", DVC_YC2_TSN)


def run_dvc_synthetic():
    """The JAX CLI's synthetic captioning task (its ``run_captioning``
    without annotations: 2 videos of 64 12-d features with a bump over
    one event each, captions [0, 3, 4, 5, 6, 0]; PDVC width 32, 6
    queries, 2 levels = 96 tokens, 1 encoder and 2 decoder layers,
    captions of 5 tokens, vocabulary 12; lr 3e-4, dropout on) through the
    port's trainer: ``DVC_SYNTH_STEPS`` steps, each with 2 K3 and 2 K4 at
    2 x 96 x 64. Fails unless loss_total falls and the last loss_bbox is
    under ``DVC_SYNTH_BBOX``. Then ``predict`` (top 3) and
    ``evaluate_dvc``: CIDEr and METEOR as ``cap_cider`` and
    ``cap_meteor``. Returns the launches."""
    import numpy as np
    from video_mamba_suite_torch.ops import LAUNCHES, reset_launches
    from video_mamba_suite_torch.tasks.captioning import (
        PDVC,
        CaptioningTrainer,
        evaluate_dvc,
    )

    set_tf32(False)
    rng = np.random.default_rng(0)
    B, T, C = 2, 64, 12
    model = PDVC(input_dim=C, num_classes=1, vocab_size=12, num_queries=6,
                 d_model=32, n_levels=2, num_encoder_layers=1,
                 num_decoder_layers=2, max_caption_len=5)
    trainer = CaptioningTrainer(model, lr=3e-4)
    feats = 0.2 * rng.standard_normal((B, T, C)).astype(np.float32)
    gt_boxes = np.zeros((B, 4, 2), np.float32)
    gt_labels = np.zeros((B, 4), np.int32)
    gt_valid = np.zeros((B, 4), bool)
    captions = np.full((B, 4, 6), -100, np.int64)
    gt_json = {}
    for b in range(B):
        s, e = 16 + 8 * b, 32 + 8 * b
        feats[b, s:e] += 2.0
        gt_boxes[b, 0] = [(s + e) / 2 / T, (e - s) / T]
        gt_valid[b, 0] = True
        captions[b, 0] = [0, 3, 4, 5, 6, 0]
        gt_json[f"v{b}"] = [dict(timestamp=[float(s), float(e)],
                                 sentence="3 4 5 6")]
    mask = np.ones((B, T), np.float32)
    reset_launches()
    t0 = time.perf_counter()
    with count_plain_calls() as plain:
        history = [trainer.train_step(feats, mask, gt_boxes, gt_labels,
                                      gt_valid, captions)
                   for _ in range(DVC_SYNTH_STEPS)]
    seconds = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    want = {"chunked_scan_fwd": 2 * DVC_SYNTH_STEPS,
            "chunked_scan_bwd": 2 * DVC_SYNTH_STEPS}
    first, last = history[0], history[-1]
    log(f"[dvc-synthetic] {DVC_SYNTH_STEPS} steps on {card_line()}: "
        f"{1e3 * seconds / DVC_SYNTH_STEPS:.2f} ms/step; loss_total "
        f"{first['loss_total']:.4f} -> {last['loss_total']:.4f}, loss_bbox "
        f"{first['loss_bbox']:.4f} -> {last['loss_bbox']:.4f}; launches "
        f"{launches}, plain-version calls {dict(plain)}")
    if launches != want or sum(plain.values()):
        raise AssertionError(f"dvc-synthetic launched {launches} (want "
                             f"{want}), plain versions {dict(plain)}")
    if not last["loss_total"] < first["loss_total"] or \
            not last["loss_bbox"] < DVC_SYNTH_BBOX:
        raise AssertionError(f"dvc-synthetic did not learn: {first} -> "
                             f"{last}")
    reset_launches()
    events = trainer.predict(feats, mask, duration=float(T), topk=3)
    result = evaluate_dvc({f"v{b}": events[b] for b in range(B)}, gt_json)
    launches["chunked_scan_fwd"] += LAUNCHES["chunked_scan_fwd"]
    log(f"[dvc-synthetic] eval: {result}; cap_cider {result['CIDEr']:.4f}, "
        f"cap_meteor {result['METEOR']:.4f} (the bench.py gates' names); "
        f"first event {events[0][0]}")
    return launches


def card_against_cpu_dvc():
    """PDVC-Mamba at the ActivityNet preset's full widths and depth (2 ViM
    layers of width 512, 2 decoder layers, the DSA head, captions of 30
    tokens), fp32 with TF32 off, dropout off, on one video of 256
    features (60 of them padding) with 6 events: the card through K3 and
    K4 against the CPU through the plain versions, the same weights.
    Every output of the forward (each layer's logits, boxes and counts,
    the query features, the memory), the teacher-forced caption logits of
    the matched events (the card's head on the CPU's query features,
    boxes and memory; end to end they are logged), the greedy tokens
    (equal); then under the CPU's match, each loss term and every
    parameter's gradient."""
    import numpy as np
    import torch
    from video_mamba_suite_torch.configs import DVC_ANET_C3D
    from video_mamba_suite_torch.ops import LAUNCHES, reset_launches
    from video_mamba_suite_torch.tasks.captioning import (
        build_captioning_trainer,
        hungarian_match,
        match_cost,
    )

    set_tf32(False)
    vocab = 200
    cpu = build_captioning_trainer(DVC_ANET_C3D, vocab, device="cpu", seed=9)
    card = build_captioning_trainer(DVC_ANET_C3D, vocab, seed=9)
    rng = np.random.default_rng(71)
    T, G, L = card.max_seq_len, card.max_events, \
        card.model.max_caption_len
    feats = rng.standard_normal((1, T, 500)).astype(np.float32)
    mask = np.ones((1, T), np.float32)
    mask[0, T - 60:], feats[0, T - 60:] = 0.0, 0.0
    boxes = np.zeros((1, G, 2), np.float32)
    boxes[0, :6] = np.stack([rng.uniform(0.2, 0.8, 6),
                             rng.uniform(0.05, 0.3, 6)], -1)
    labels = np.zeros((1, G), np.int64)
    valid = np.zeros((1, G), bool)
    valid[0, :6] = True
    captions = np.full((1, G, L), -100, np.int64)
    for g in range(6):
        n = int(rng.integers(6, L - 1))
        captions[0, g, :n + 2] = [1, *rng.integers(4, vocab, n), 2]
    t0 = time.perf_counter()

    def run(trainer, match=None):
        on = trainer._on
        x = [on(feats, torch.float32), on(mask, torch.float32),
             on(boxes, torch.float32), on(labels, torch.long),
             on(valid, torch.bool), on(captions, torch.long)]
        trainer.model.eval()
        out = trainer.model(x[0], x[1])
        if match is None:
            cost = match_cost(out["pred_logits"].detach(),
                              out["pred_boxes"].detach(), x[3], x[2], x[4])
            match = hungarian_match(cost, valid.sum(1)).cpu()
        idx = match.to(trainer.device)
        logits = trainer.matched_caption_logits(out, x[5], idx, T)
        losses = trainer.losses(out, x[0], x[2], x[3], x[4], x[5], idx)
        trainer.model.zero_grad(set_to_none=True)
        losses["loss_total"].backward()
        with torch.no_grad():
            caps = trainer.forward_captions(x[0], x[1])[1]
        return out, logits, losses, caps, match

    want_out, want_logits, want_losses, want_caps, match = run(cpu)
    reset_launches()
    got_out, got_logits, got_losses, got_caps, _ = run(card, match)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    errs = {}
    for i, (g, w) in enumerate(zip(got_out["aux_outputs"] + [got_out],
                                   want_out["aux_outputs"] + [want_out])):
        for k in ("pred_logits", "pred_boxes", "pred_count"):
            errs[f"{k}[{i}]"] = _rel_err(g[k], w[k])
    for k in ("query_feats", "memory"):
        errs[k] = _rel_err(got_out[k], want_out[k])
    # the caption head on the CPU's query features, boxes and memory (its
    # own 30 steps), and end to end (each device's own forward feeding
    # it: the head's recurrence carries the decoder's differences on)
    cap_valid = torch.as_tensor(valid)
    with torch.no_grad():
        same_inputs = {k: want_out[k].detach().cuda() for k in
                       ("query_feats", "pred_boxes", "memory")}
        head_logits = card.matched_caption_logits(
            same_inputs, torch.as_tensor(captions).cuda(),
            match.cuda(), T)
    errs["caption_logits"] = _rel_err(head_logits[cap_valid.cuda()],
                                      want_logits[cap_valid])
    end_to_end = _rel_err(got_logits[cap_valid.cuda()],
                          want_logits[cap_valid])
    loss_err = max(abs(got_losses[k].item() - v.item()) / abs(v.item())
                   for k, v in want_losses.items())
    same_tokens = torch.equal(got_caps.cpu(), want_caps)
    cpu_grads = {n: p.grad for n, p in cpu.model.named_parameters()}
    floor = CARD_CPU_DVC_GRAD_FLOOR * max(
        g.abs().max().item() for g in cpu_grads.values() if g is not None)
    worst, worst_name, missing = 0.0, "", []
    for name, p in card.model.named_parameters():
        w = cpu_grads[name]
        if (p.grad is None) != (w is None) or (
                p.grad is not None and not torch.isfinite(p.grad).all()):
            missing.append(name)
            continue
        if w is None:
            continue
        rel = ((p.grad.cpu() - w).abs().max()
               / max(w.abs().max().item(), floor)).item()
        if rel >= worst:
            worst, worst_name = rel, name
    log(f"[card-vs-cpu] PDVC-Mamba (ActivityNet widths, depth 2 + 2, DSA "
        f"head) fp32, 1 x {T} features ({T - 60} valid), 6 events of "
        f"{L}-token captions, TF32 off, dropout off: forward and caption "
        f"logits, largest error over scale " + ", ".join(
            f"{k} {v:.3e}" for k, v in errs.items())
        + f" (tol {CARD_CPU_DVC_REL_TOL}; the caption logits end to end "
        f"{end_to_end:.3e}); greedy tokens "
        f"{'equal' if same_tokens else 'DIFFER'}; under the CPU's match "
        f"{match.tolist()}: losses within {loss_err:.3e} (tol "
        f"{CARD_CPU_DVC_REL_TOL}); largest gradient difference over the "
        f"CPU gradient's scale (floor {CARD_CPU_DVC_GRAD_FLOOR} of the "
        f"largest) {worst:.3e} ({worst_name}; tol "
        f"{CARD_CPU_DVC_GRAD_REL_TOL}) over {len(cpu_grads)} parameters; "
        f"card launches {launches}; {time.perf_counter() - t0:.1f} s")
    n = 2 * DVC_ENCODER_LAYERS
    if launches != {"chunked_scan_fwd": 2 * n, "chunked_scan_bwd": n}:
        raise AssertionError(f"the card's PDVC-Mamba launched {launches}")
    if missing or not same_tokens or \
            not loss_err <= CARD_CPU_DVC_REL_TOL or \
            not all(e <= CARD_CPU_DVC_REL_TOL for e in errs.values()) or \
            not worst <= CARD_CPU_DVC_GRAD_REL_TOL:
        raise AssertionError(f"card and CPU PDVC-Mamba disagree (no or "
                             f"non-finite gradient: {missing})")


# ---------------------------------------------------------------------------
# the task CLI: the synthetic trajectories, THUMOS-14 through the
# CLI with preemption and resume, and the card's checkpoint on the CPU

# K1-K6: the scan kernels a CLI run must launch at least one of
CLI_SCAN_KERNELS = ("short_bidir_fwd", "short_bidir_bwd", "chunked_scan_fwd",
                    "chunked_scan_bwd", "short_scan_fwd", "short_scan_bwd")
CLI_NUM = r"(?:np\.float64\()?([0-9.eE+-]+)"
# (label, argv, [(name, pattern)]): the synthetic runs at bench.py's
# bench_cli_trajectories epochs where it runs the task (VTG 50, MIR 20,
# TAS 50, captioning 20, anticipation 40, recognition 100), else the CLI's
# default 5; the numbers each prints, under bench.py's gate names where it
# has one (printed only: no gate here)
CLI_RUNS = [
    ("vtg", ["vtg", "--synthetic", "--epochs", "50"],
     [("vtg_r1_05", r"'R1@0.5': ([0-9.eE+-]+)"),
      ("vtg_map_avg", r"'mAP_avg': ([0-9.eE+-]+)")]),
    ("mir", ["egocentric", "--synthetic", "--epochs", "20", "--set",
             "train.mode=mir"],
     [("mir_avg_map", r"avg_map ([0-9.eE+-]+)")]),
    ("tas", ["tas", "--synthetic", "--epochs", "50"],
     [("tas_f1_50", r"eval: \{[^}]*'F1@50': " + CLI_NUM)]),
    ("captioning", ["captioning", "--synthetic", "--epochs", "20"],
     [("cap_cider", r"eval: \{[^}]*'CIDEr': " + CLI_NUM),
      ("cap_meteor", r"eval: \{[^}]*'METEOR': " + CLI_NUM)]),
    ("anticipation", ["anticipation", "--synthetic", "--epochs", "40"],
     [("ant_mean_ap", r"eval: \{[^}]*'mean_AP': " + CLI_NUM)]),
    ("recognition", ["recognition", "--synthetic", "--epochs", "100"],
     [("rec_top1", r"eval: \{[^}]*'top1': " + CLI_NUM)]),
    ("tal", ["tal", "--synthetic"],
     [("tal avg mAP", r"mAP per tIoU: .*, avg ([0-9.]+)")]),
    ("pretrain", ["egocentric", "--synthetic"],
     [("retrieval acc", r"retrieval acc ([0-9.]+)")]),
    ("cls", ["egocentric", "--synthetic", "--set", "train.mode=cls"],
     [("action top-1", r"action top-1 ([0-9.]+)")]),
]
TAL_CLI_TRAIN = 4                # training videos of the THUMOS-layout set
TAL_CLI_VAL = 2                  # its validation videos
TAL_CLI_BATCH = 2                # the preset's batch
# steps a video: TalDataset (as the JAX one) reads a (T, C) file as time
# by channels only where T > C, so with THUMOS's 3200 channels a video
# needs more than 3200 steps; training takes windows of 2304 of them
TAL_CLI_LENGTH = 3264
TAL_CLI_EPOCHS = 3               # epochs of the preempted and resumed runs
TAL_CLI_CHILD_TIMEOUT = 600      # seconds the preempted child may take
TAL_LAYERS = 7                   # DBM layers of the preset: 2 K3 (2 K4) each
# the restored model's logits and offsets, card against CPU: each within
# this of the output's largest magnitude over the pyramid's levels. A
# coarse level's own largest offset is a third to two thirds of the
# finest's while the difference stays about 5e-6 at every level, so
# against its own scale a level reaches 1.0e-5 (PERF.md §6)
CARD_CPU_CKPT_REL_TOL = 1e-5
TAL_EVAL_REPEATS = 3             # timed passes of the eval breakdown
CLI_TAL = {}                     # phase 36's dataset and checkpoint


def cli_run(argv):
    """``cli.main(argv)`` in this process: (its stdout, the kernel
    launches and plain-version calls of the run, its wall seconds)."""
    import io

    import torch
    from video_mamba_suite_torch import cli
    from video_mamba_suite_torch.ops import LAUNCHES, reset_launches

    buf = io.StringIO()
    reset_launches()
    t0 = time.perf_counter()
    with count_plain_calls() as plain, contextlib.redirect_stdout(buf):
        cli.main(argv)
    torch.cuda.synchronize()
    return (buf.getvalue(), dict(LAUNCHES), dict(plain),
            time.perf_counter() - t0)


def _first_number(pattern, text):
    m = re.search(pattern, text)
    return float(m.group(1)) if m else float("nan")


def _ends(text):
    """The first and last lines of a run's output."""
    lines = text.strip().splitlines()
    return lines[:1] + lines[-2:] if len(lines) > 3 else lines


def run_cli_synthetic():
    """Phase 35: the CLI's synthetic trajectories through ``cli.main`` in
    this process (``CLI_RUNS``: the seven tasks, the MIR and
    classification modes). Each run launches at least one of K1-K6 and no
    plain version; prints its launches, wall seconds and the numbers
    ``bench.py`` reads. Returns the launches."""
    launches = collections.Counter()
    card = card_line()
    for label, argv, numbers in CLI_RUNS:
        out, counts, plain, seconds = cli_run(argv)
        values = {name: _first_number(p, out) for name, p in numbers}
        log(f"[cli-synthetic] {label} ({' '.join(argv)}) on {card}: "
            f"{seconds:.2f} s; launches {counts}; plain-version calls "
            f"{plain}; {', '.join(f'{k} {v}' for k, v in values.items())}")
        for line in _ends(out):
            log(f"[cli-synthetic] {label} | {line[:300]}")
        if not any(counts.get(k) for k in CLI_SCAN_KERNELS) or \
                sum(plain.values()) or not all(
                    math.isfinite(v) for v in values.values()):
            raise AssertionError(f"the CLI's {label} run launched {counts}, "
                                 f"plain versions {plain}, printed "
                                 f"{values}")
        launches.update(counts)
    return dict(launches)


def write_tal_dataset(root, train, val, length, channels, classes, seed):
    """A THUMOS-layout dataset under ``root``: ``anno.json`` (TalDataset's
    database: subset, duration, 30 fps, two actions a video) and
    ``feats/<video>.npy`` of (``length``, ``channels``) float16 features
    from ``seed``. Returns the CLI's ``--set`` pairs that name it."""
    import numpy as np

    rng = np.random.default_rng(seed)
    feat_dir = os.path.join(root, "feats")
    os.makedirs(feat_dir, exist_ok=True)
    fps, stride = 30.0, 4
    duration = length * stride / fps
    db = {}
    for i in range(train + val):
        vid = f"video_{i}"
        np.save(os.path.join(feat_dir, vid + ".npy"),
                rng.standard_normal((length, channels), np.float32)
                .astype(np.float16))
        actions = []
        for _ in range(2):
            start = rng.uniform(0.05, 0.75) * duration
            end = min(start + rng.uniform(0.05, 0.2) * duration, duration)
            actions.append(dict(segment=[start, end],
                                label_id=int(rng.integers(classes))))
        db[vid] = dict(subset="training" if i < train else "validation",
                       duration=duration, fps=fps, annotations=actions)
    anno = os.path.join(root, "anno.json")
    with open(anno, "w") as f:
        json.dump({"database": db}, f)
    return [f"dataset.json_file={anno}", f"dataset.feat_folder={feat_dir}"]


def cli_preempted(argv, timeout):
    """``python -m video_mamba_suite_torch.cli argv`` in a child process,
    sent SIGTERM once it prints ``epoch 0:``: (its exit code, its output,
    its seconds, the seconds from the signal to its exit). The child is
    killed at ``timeout``."""
    import signal
    import threading

    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "video_mamba_suite_torch.cli", *argv],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=here)
    watchdog = threading.Timer(timeout, proc.kill)
    watchdog.start()
    lines, sent = [], None
    try:
        for line in proc.stdout:
            lines.append(line)
            if sent is None and line.startswith("epoch 0:"):
                proc.send_signal(signal.SIGTERM)
                sent = time.perf_counter()
        rc = proc.wait()
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    end = time.perf_counter()
    return (rc, "".join(lines), end - t0,
            None if sent is None else end - sent)


def _epochs(text):
    return [int(e) for e in re.findall(r"^epoch (\d+):", text, re.M)]


def run_cli_tal_thumos():
    """Phase 36: ``tal --preset tal_thumos`` through the CLI on a
    THUMOS-layout dataset written from ``--seed`` 0 (``TAL_CLI_TRAIN``
    training and ``TAL_CLI_VAL`` validation videos of ``TAL_CLI_LENGTH``
    steps x 3200 features): one epoch in this process (14 K3 with
    checkpoints + 14 K4 a step, 14 K3 a validation video, no plain
    version); then ``--epochs 3 --ckpt D`` in a child process, sent
    SIGTERM once it prints ``epoch 0:``: it exits 0 with ``latest_step(D)``
    the last epoch it printed, before the last; then the same command in
    this process resumes after that epoch, trains only the epochs after
    it and prints the mAP line. Returns the launches of this process's
    runs."""
    import atexit
    import gc
    import shutil
    import tempfile

    import torch
    from video_mamba_suite_torch.configs import TAL_THUMOS
    from video_mamba_suite_torch.utils import latest_step

    root = tempfile.mkdtemp(prefix="cli-tal-thumos-")
    atexit.register(shutil.rmtree, root, ignore_errors=True)
    d = TAL_THUMOS["dataset"]
    t0 = time.perf_counter()
    sets = write_tal_dataset(root, TAL_CLI_TRAIN, TAL_CLI_VAL,
                             TAL_CLI_LENGTH, d["input_dim"],
                             d["num_classes"], seed=0)
    write_s = time.perf_counter() - t0
    base = ["tal", "--preset", "tal_thumos", "--set", *sets]
    card = card_line()

    out, counts, plain, seconds = cli_run(base + ["--epochs", "1"])
    steps = TAL_CLI_TRAIN // TAL_CLI_BATCH
    want = {"chunked_scan_fwd": 2 * TAL_LAYERS * (steps + TAL_CLI_VAL),
            "chunked_scan_bwd": 2 * TAL_LAYERS * steps}
    log(f"[cli-tal-thumos] dataset of {TAL_CLI_TRAIN} + {TAL_CLI_VAL} "
        f"videos x {TAL_CLI_LENGTH} steps x {d['input_dim']} written in "
        f"{write_s:.1f} s; one epoch ({steps} steps) and the eval of "
        f"{TAL_CLI_VAL} videos in this process on {card}: {seconds:.2f} s; "
        f"launches {counts} (want {want}); plain-version calls {plain}")
    for line in _ends(out):
        log(f"[cli-tal-thumos] | {line[:300]}")
    if counts != want or sum(plain.values()) or "epoch 0:" not in out or \
            "mAP per tIoU" not in out:
        raise AssertionError(f"the CLI's THUMOS epoch launched {counts}, "
                             f"plain versions {plain}: {out}")
    launches = collections.Counter(counts)
    gc.collect()
    torch.cuda.empty_cache()

    ckpt = os.path.join(root, "ckpt")
    argv = base + ["--epochs", str(TAL_CLI_EPOCHS), "--ckpt", ckpt]
    rc, child, child_s, after_signal = cli_preempted(argv,
                                                     TAL_CLI_CHILD_TIMEOUT)
    printed = _epochs(child)
    last = latest_step(ckpt)
    log(f"[cli-tal-thumos] child `python -m video_mamba_suite_torch.cli "
        f"{' '.join(argv[:3])} ... --epochs {TAL_CLI_EPOCHS} --ckpt D`, "
        f"SIGTERM at 'epoch 0:': exit {rc} after {child_s:.1f} s "
        f"({after_signal if after_signal is None else round(after_signal, 2)}"
        f" s after the signal); epochs printed {printed}, latest_step(D) "
        f"{last}, mAP line {'mAP per tIoU' in child}")
    for line in child.strip().splitlines()[-4:]:
        log(f"[cli-tal-thumos] child | {line[:300]}")
    if rc != 0 or after_signal is None or not printed or \
            last != printed[-1] or last >= TAL_CLI_EPOCHS - 1 or \
            "mAP per tIoU" not in child:
        raise AssertionError(f"the preempted CLI run exited {rc}, printed "
                             f"epochs {printed}, left step {last}:\n"
                             f"{child}")

    out, counts, plain, seconds = cli_run(argv)
    resumed = f"[resume] restored epoch {last} from {ckpt}"
    trained = _epochs(out)
    steps_after = steps * (TAL_CLI_EPOCHS - 1 - last)
    want = {"chunked_scan_fwd": 2 * TAL_LAYERS * (steps_after
                                                  + TAL_CLI_VAL),
            "chunked_scan_bwd": 2 * TAL_LAYERS * steps_after}
    log(f"[cli-tal-thumos] rerun in this process: {seconds:.2f} s; "
        f"'{resumed}' {resumed in out}; epochs trained {trained}; "
        f"latest_step(D) {latest_step(ckpt)}; launches {counts} (want "
        f"{want}); plain-version calls {plain}")
    for line in _ends(out):
        log(f"[cli-tal-thumos] rerun | {line[:300]}")
    if resumed not in out or \
            trained != list(range(last + 1, TAL_CLI_EPOCHS)) or \
            latest_step(ckpt) != TAL_CLI_EPOCHS - 1 or counts != want or \
            sum(plain.values()) or "mAP per tIoU" not in out:
        raise AssertionError(f"the resumed CLI run printed {out}; "
                             f"launches {counts}, plain {plain}")
    launches.update(counts)
    CLI_TAL.update(root=root, sets=sets, ckpt=ckpt)
    return dict(launches)


def tal_cli_architecture(sets):
    """The ``TalTrainer`` arguments that fix the modules' shapes, as the
    CLI reads them from the ``tal_thumos`` preset under ``sets``."""
    from video_mamba_suite_torch import cli
    from video_mamba_suite_torch.configs import PRESETS
    from video_mamba_suite_torch.utils import Config

    cfg = Config(PRESETS["tal_thumos"]).override(cli._parse_overrides(sets))
    d, m = cfg["dataset"], cfg.get("model", {})
    return dict(input_dim=d["input_dim"],
                num_classes=d.get("num_classes", 20),
                max_seq_len=d.get("max_seq_len", 2304),
                embd_dim=m.get("embd_dim", 512),
                backbone_arch=tuple(m.get("backbone_arch", (2, 2, 5))),
                regression_range=m.get("regression_range"),
                mixer=m.get("mixer", "dbm"))


def _leaves(state, path="state"):
    """(path, value) of every leaf of a nested state dict."""
    if isinstance(state, dict):
        for k, v in state.items():
            yield from _leaves(v, f"{path}.{k}")
    elif isinstance(state, (list, tuple)):
        for i, v in enumerate(state):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, state


def _mismatched(saved, restored, skip=()):
    """The leaves of ``restored`` that differ from ``saved`` bit for bit
    (tensors under ``torch.equal``, dtype and shape too; other leaves
    under ``==``), leaving aside paths that start with one of ``skip``."""
    import torch

    want = dict(_leaves(saved))
    got = dict(_leaves(restored))
    bad = sorted(set(want) ^ set(got))
    for path, w in want.items():
        if path not in got or path.startswith(skip):
            continue
        g = got[path]
        if isinstance(w, torch.Tensor):
            if not (isinstance(g, torch.Tensor) and g.dtype == w.dtype
                    and g.shape == w.shape and torch.equal(g.cpu(), w)):
                bad.append(path)
        elif g != w:
            bad.append(path)
    return [p for p in bad if not p.startswith(skip)]


def restore_card_and_cpu(ckpt, sets):
    """The newest checkpoint of ``ckpt`` (a CLI run of ``tal --preset
    tal_thumos --set sets``) restored into a ``TalTrainer`` on the card
    and one on the CPU, and both run, fp32 with TF32 off, on the first
    validation video: (the restored step, the leaves of each trainer's
    state that differ from the file's bit for bit (the CPU's generator
    aside: a card's generator state cannot continue on the CPU), the
    largest difference of the logits and of the offsets (the EMA
    weights) over the output's scale, its largest magnitude over every
    level (and, logged beside it, each level's difference over that
    level's own scale), the card trainer, the video)."""
    import warnings

    import torch
    from video_mamba_suite_torch.tasks.tal import (
        TalDataset,
        TalTrainer,
        collate_tal,
    )
    from video_mamba_suite_torch.utils import (
        latest_step,
        restore_checkpoint,
    )

    set_tf32(False)
    step = latest_step(ckpt)
    saved = restore_checkpoint(ckpt, step, map_location="cpu")
    kw = tal_cli_architecture(sets)
    card, cpu = TalTrainer(**kw), TalTrainer(**kw, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # the CPU's generator
        restored = (card.restore(ckpt), cpu.restore(ckpt))
    bad = {"card": _mismatched(saved, card.state_dict()),
           "cpu": _mismatched(saved, cpu.state_dict(),
                              skip=("state.generator",))}
    if restored != (step, step):
        bad["step"] = [f"restored {restored}, saved {step}"]
    files = {s.split("=", 1)[0]: s.split("=", 1)[1] for s in sets}
    item = TalDataset(files["dataset.json_file"],
                      files["dataset.feat_folder"], split=["validation"],
                      feat_stride=4, num_frames=16,
                      max_seq_len=kw["max_seq_len"], is_training=False)[0]
    outs = []
    for trainer in (card, cpu):
        model = trainer.inference_model()
        feats, mask, *_ = collate_tal(
            [item], kw["max_seq_len"], trainer.max_num_gt, training=False,
            max_div_factor=model.scale_factor ** model.backbone_arch[2])
        with torch.inference_mode():
            outs.append(model(torch.as_tensor(feats).to(trainer.device),
                              torch.as_tensor(mask).to(trainer.device)))
    errs = {}
    for i, kind in enumerate(("logits", "offsets")):
        diffs = [(g.detach().float().cpu() - w).abs().max().item()
                 for g, w in zip(outs[0][i], outs[1][i])]
        scales = [w.abs().max().item() for w in outs[1][i]]
        errs[kind] = max(diffs) / max(scales)
        errs[f"{kind} by level"] = max(d / s for d, s in zip(diffs, scales))
    return step, bad, errs, card, item


def card_against_cpu_ckpt():
    """Phase 37: the newest checkpoint of phase 36's CLI runs (saved on
    the card) restored into a ``TalTrainer`` on the card and one on the
    CPU at the THUMOS preset: every restored tensor equals the file's bit
    for bit, and both run the first validation video within
    ``CARD_CPU_CKPT_REL_TOL`` of the logits' and the offsets' scales
    (fp32, TF32 off)."""
    from video_mamba_suite_torch.ops import LAUNCHES, reset_launches

    if not CLI_TAL:
        raise AssertionError("card-vs-cpu-ckpt reads the checkpoint of "
                             "cli-tal-thumos: run that phase first")
    t0 = time.perf_counter()
    reset_launches()
    step, bad, errs, card, item = restore_card_and_cpu(CLI_TAL["ckpt"],
                                                       CLI_TAL["sets"])
    launches = dict(LAUNCHES)
    err = max(errs["logits"], errs["offsets"])
    log(f"[card-vs-cpu-ckpt] the CLI's THUMOS checkpoint (epoch {step}) "
        f"restored on the card and on the CPU: leaves differing from the "
        f"file {bad}; one validation video of {TAL_CLI_LENGTH} steps, fp32 "
        f"TF32 off, EMA weights: logits {errs['logits']:.3e}, offsets "
        f"{errs['offsets']:.3e} of the output's scale (tol "
        f"{CARD_CPU_CKPT_REL_TOL}); of each level's own scale at most "
        f"{errs['logits by level']:.3e} and {errs['offsets by level']:.3e}; "
        f"the card's launches {launches}; "
        f"{time.perf_counter() - t0:.1f} s")
    if any(bad.values()) or not err <= CARD_CPU_CKPT_REL_TOL:
        raise AssertionError(f"the restored checkpoint differs: {bad}, "
                             f"outputs {err}")


@contextlib.contextmanager
def nms_by_numpy(on: bool):
    """While the block runs, with ``on``, the TAL NMS runs its numpy plain
    versions (``nms_1d_ref``, ``soft_nms_1d_ref``) in place of the native
    op."""
    nms = importlib.import_module("video_mamba_suite_torch.tasks.tal.nms")
    native = nms.nms_1d, nms.soft_nms_1d
    if on:
        nms.nms_1d, nms.soft_nms_1d = nms.nms_1d_ref, nms.soft_nms_1d_ref
    try:
        yield
    finally:
        nms.nms_1d, nms.soft_nms_1d = native


def tal_eval_breakdown(trainer, items, tag):
    """``predict_video``'s parts timed apart, ms per video (the median of
    ``TAL_EVAL_REPEATS`` passes over ``items``): the collate on the host,
    the copy to the card, the forward (synchronised), the decode (top-k
    on the card, one copy to the host), then the host's soft-NMS without
    voting and with it, by the plain numpy versions and by the native op
    (the two give the same detections); and ``predict_video`` whole."""
    import numpy as np
    import torch
    from video_mamba_suite_torch.tasks.tal import (
        batched_nms,
        collate_tal,
        decode_single_video,
    )

    model = trainer.inference_model()
    cfg = trainer.test_cfg
    nms_kw = dict(iou_threshold=cfg["iou_threshold"],
                  min_score=cfg["min_score"], max_seg_num=cfg["max_seg_num"],
                  use_soft_nms=cfg["nms_method"] == "soft",
                  multiclass=cfg["multiclass_nms"], sigma=cfg["nms_sigma"])
    parts = collections.defaultdict(list)
    candidates = []
    for _ in range(TAL_EVAL_REPEATS):
        for item in items:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.predict_video(item)
            parts["predict_video (native)"].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            feats, mask, *_ = collate_tal(
                [item], trainer.max_seq_len, trainer.max_num_gt,
                training=False,
                max_div_factor=model.scale_factor ** model.backbone_arch[2])
            t1 = time.perf_counter()
            feats = torch.as_tensor(feats).cuda()
            mask = torch.as_tensor(mask).cuda()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            parts["collate"].append(t1 - t0)
            parts["to card"].append(t2 - t1)
            t0 = time.perf_counter()
            with torch.inference_mode():
                cls_logits, offsets, fpn_masks = model(feats, mask)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                segs, scores, cls = decode_single_video(
                    trainer.points(feats.shape[1]),
                    [m[0] for m in fpn_masks], [c[0] for c in cls_logits],
                    [o[0] for o in offsets], cfg["pre_nms_thresh"],
                    cfg["pre_nms_topk"], cfg["duration_thresh"])
            t2 = time.perf_counter()
            parts["forward"].append(t1 - t0)
            parts["decode"].append(t2 - t1)
            candidates.append(len(scores))
            results = {}
            for impl, plain in (("numpy", True), ("native", False)):
                ta = time.perf_counter()
                with nms_by_numpy(plain):
                    batched_nms(segs, scores, cls, voting_thresh=0.0,
                                **nms_kw)
                    tb = time.perf_counter()
                    results[impl] = batched_nms(
                        segs, scores, cls,
                        voting_thresh=cfg["voting_thresh"], **nms_kw)
                tc = time.perf_counter()
                parts[f"soft-NMS {impl}"].append(tb - ta)
                parts[f"soft-NMS + voting {impl}"].append(tc - tb)
            got, want = results["native"], results["numpy"]
            if not (np.array_equal(got[2], want[2])
                    and np.allclose(got[0], want[0], rtol=1e-6)
                    and np.allclose(got[1], want[1], rtol=1e-6)):
                raise AssertionError("the native and numpy NMS disagree")
    ms = {k: 1e3 * statistics.median(v) for k, v in parts.items()}
    for impl in ("numpy", "native"):
        ms[f"voting {impl}"] = (ms[f"soft-NMS + voting {impl}"]
                                - ms[f"soft-NMS {impl}"])
        ms[f"host total {impl}"] = (ms["collate"] + ms["decode"]
                                    + ms[f"soft-NMS + voting {impl}"])
    log(f"[{tag}] THUMOS eval's parts, ms a video (median of "
        f"{TAL_EVAL_REPEATS} passes over {len(items)} videos, "
        f"{statistics.median(candidates):.0f} candidates into NMS, "
        f"{card_line()}): "
        + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()))
    return ms


# ---------------------------------------------------------------------------
# the video data stack: the CLI's raw-video modes on .npy videos, VTG's
# run-on-video, and the device stages card against CPU

VIDEO_FILES = 16                 # videos (clips) of each raw-video run
VIDEO_BATCH = 8                  # their batch: two steps an epoch
REC_VIDEO_FRAMES = 48            # frames of a K400-layout video (224²)
EGO_VIDEO_FRAMES = 32            # frames of an egocentric clip (224²)
PREFETCH_WORKERS = 2             # PrefetchLoader threads of the A/B
VIVIM_STEP = {"chunked_scan_fwd": VIVIM_LAUNCHES,
              "chunked_scan_bwd": VIVIM_LAUNCHES}
# UniVTG's run-on-video: a 60 s video at 30 fps, CLIP ViT-B/32's widths
ROV_FRAMES, ROV_HEIGHT, ROV_WIDTH = 1800, 128, 170
ROV_IMAGE = dict(img_size=224, patch_size=32, width=768, layers=12,
                 heads=12, output_dim=512)
ROV_TEXT = dict(context_length=77, vocab_size=49408, width=512, heads=8,
                layers=12, output_dim=512)
ROV_QUERY = "a person opens the fridge and takes out a bottle of water"
ROV_DEPTH = 2                    # towers' and model's depth, card vs CPU
# preprocess_clip card against CPU: 16 frames of 256 x 340 to 224², train
# mode at fixed offsets; each value within this (normalised values reach
# about 2; the two devices' resize kernels sum in other orders)
PREPROCESS_CLIP_SHAPE = (16, 256, 340)
CARD_CPU_PREPROCESS_TOL = 1e-4
# ground_video card against CPU (fp32, TF32 off): spans as fractions of
# the duration, saliency against its largest magnitude
CARD_CPU_ROV_TOL = 1e-4


def write_npy_videos(root, names, frames, height, width, seed):
    """uint8 (frames, height, width, 3) ``.npy`` videos from ``seed``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    for name in names:
        np.save(os.path.join(root, name), rng.integers(
            0, 256, (frames, height, width, 3), dtype=np.uint8))


@contextlib.contextmanager
def timed_calls(**targets):
    """Wrap each ``key=(owner, attribute)`` so that every call goes to
    ``events`` as (key, wall seconds), in the order the calls end;
    ``last[key]`` keeps the last call's arguments."""
    events, last = [], {}
    originals = {k: getattr(o, a) for k, (o, a) in targets.items()}

    def wrap(key, fn):
        def inner(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            events.append((key, time.perf_counter() - t0))
            last[key] = a
            return out
        return inner

    for key, (owner, attr) in targets.items():
        setattr(owner, attr, wrap(key, originals[key]))
    try:
        yield events, last
    finally:
        for key, (owner, attr) in targets.items():
            setattr(owner, attr, originals[key])


def step_breakdown(events):
    """Per ``step`` event: the seconds of the last ``VIDEO_BATCH`` decode
    and augment calls before it (the step's rows) and its own."""
    steps, pending = [], collections.defaultdict(list)
    for key, seconds in events:
        if key == "step":
            steps.append(({k: sum(v[-VIDEO_BATCH:]) for k, v in
                           pending.items()}, seconds))
            pending.clear()
        else:
            pending[key].append(seconds)
    return steps


def video_cli_phase(tag, argv, dataset_cls, trainer_cls, per_step, extra,
                    augment=False):
    """``cli.main(argv)`` on ``.npy`` videos with the host's decode (the
    dataset's ``__getitem__``), augment and the trainer's ``train_step``
    timed call by call: exactly ``per_step`` launches a step plus
    ``extra`` (the run's evaluation), no plain version; per step the
    decode and augment ms of its rows and the step's ms; then the step's
    device busy share from a profile window of one more step on the last
    batch. Returns (the launches, the printed text, the trainer)."""
    import torch
    from video_mamba_suite_torch.data import video_augment

    targets = dict(decode=(dataset_cls, "__getitem__"),
                   step=(trainer_cls, "train_step"))
    if augment:
        targets["augment"] = (video_augment, "train_augment_clip")
    with timed_calls(**targets) as (events, last):
        out, launches, plain, seconds = cli_run(argv)
    steps = step_breakdown(events)
    want = dict(extra)
    for k, v in per_step.items():
        want[k] = v * len(steps) + extra.get(k, 0)
    if len(steps) != VIDEO_FILES // VIDEO_BATCH or launches != want or \
            sum(plain.values()) or "epoch 0: loss" not in out:
        raise AssertionError(f"{tag}: {len(steps)} steps launched "
                             f"{launches} (want {want}), plain versions "
                             f"{plain}: {out[-500:]}")
    card = card_line()
    for i, (host, step) in enumerate(steps):
        log(f"[{tag}] step {i} on {card}: " + ", ".join(
            f"{1e3 * v:.2f} ms {k}" for k, v in host.items())
            + f" ({VIDEO_BATCH} videos), {1e3 * step:.2f} ms step")
    log(f"[{tag}] {' '.join(argv)}: {seconds:.2f} s in all, "
        f"{sum(k == 'decode' for k, _ in events)} decodes; launches "
        f"{launches}; plain-version calls {plain}")
    for line in _ends(out):
        log(f"[{tag}] | {line[:300]}")
    trainer, batch = last["step"][0], last["step"][1:]
    torch.cuda.synchronize()
    profile_seen("step", lambda: trainer.train_step(*batch),
                 tag=f"profile-{tag}", calls=1)
    return launches, out, trainer


def run_cli_recognition_video():
    """The CLI's recognition real-data mode at the recognition_k400_vivim_
    tiny preset (ViViM-T, 16 frames of 224², 400 classes, mixup / cutmix,
    RandAugment rand-m7-n4-mstd0.5-inc1 and erasing 0.25 on the host) on a
    K400-layout csv of 16 ``.npy`` videos of 48 frames, batch 8 (the
    preset's 256 cut to 8), one epoch: 2 steps of exactly 48 K3 with
    checkpoints and 48 K4. Then the same two steps' work (decode,
    augment, step) fed through ``PrefetchLoader`` (2 workers, pinned
    copies): ms a step. Returns the CLI run's launches."""
    import tempfile

    import numpy as np
    import torch
    from video_mamba_suite_torch.cli import _epoch_order
    from video_mamba_suite_torch.configs import PRESETS
    from video_mamba_suite_torch.data import PrefetchLoader
    from video_mamba_suite_torch.data.video_augment import make_train_augment
    from video_mamba_suite_torch.data.video_datasets import \
        VideoClassificationDataset
    from video_mamba_suite_torch.ops import LAUNCHES, reset_launches
    from video_mamba_suite_torch.tasks.recognition import RecognitionTrainer

    set_tf32(True)
    with tempfile.TemporaryDirectory(prefix="rec-video-") as root:
        names = [f"k400_{i:02d}.npy" for i in range(VIDEO_FILES)]
        write_npy_videos(root, names, REC_VIDEO_FRAMES, 224, 224, seed=0)
        labels = np.random.default_rng(0).integers(0, 400, VIDEO_FILES)
        labels[0] = 399                # 400 classes from the csv
        csv = os.path.join(root, "train.csv")
        with open(csv, "w") as f:
            f.writelines(f"{n} {l}\n" for n, l in zip(names, labels))
        argv = ["recognition", "--preset", "recognition_k400_vivim_tiny",
                "--epochs", "1", "--set", f"dataset.train_csv={csv}",
                f"dataset.video_root={root}",
                f"loader.batch_size={VIDEO_BATCH}"]
        launches, _, trainer = video_cli_phase(
            "cli-recognition-video", argv, VideoClassificationDataset,
            RecognitionTrainer, VIVIM_STEP, {}, augment=True)

        # the same two steps' work through the prefetch loader: each
        # batch decoded and augmented on a worker (its own augment
        # generator, so that the workers' draws do not interleave)
        ds = VideoClassificationDataset(csv, root, num_frames=16)
        aug_fn = make_train_augment(PRESETS["recognition_k400_vivim_tiny"]
                                    ["aug"])
        order = _epoch_order(len(ds), 0)

        def batch_fn(i):
            rng = np.random.default_rng(i)
            rows = [ds[j] for j in order[i * VIDEO_BATCH:
                                         (i + 1) * VIDEO_BATCH]]
            return (np.stack([aug_fn(r["frames"][0], rng) for r in rows]),
                    np.array([r["label"] for r in rows], np.int32))

        steps = VIDEO_FILES // VIDEO_BATCH
        torch.cuda.synchronize()
        reset_launches()
        times = []
        t0 = time.perf_counter()
        with count_plain_calls() as plain:
            for videos, labels in PrefetchLoader(batch_fn, steps,
                                                 num_workers=PREFETCH_WORKERS):
                loss = trainer.train_step(videos, labels)
                times.append(time.perf_counter() - t0)
                t0 = time.perf_counter()
        got = dict(LAUNCHES)
        want = {k: v * steps for k, v in VIVIM_STEP.items()}
        if got != want or sum(plain.values()) or not math.isfinite(loss):
            raise AssertionError(f"prefetched recognition steps launched "
                                 f"{got} (want {want}), plain versions "
                                 f"{dict(plain)}, loss {loss}")
        log(f"[cli-recognition-video] {steps} steps through PrefetchLoader "
            f"({PREFETCH_WORKERS} workers, pinned) on {card_line()}: "
            + ", ".join(f"{1e3 * t:.2f}" for t in times)
            + f" ms a step (decode, augment and copy overlapped); loss "
            f"{loss:.4f}")
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
    return launches


def write_ego_dataset(root, seed):
    """16 egocentric ``.npy`` clips (32 frames of 224²), a metadata json
    of their captions and a csv of action labels."""
    import numpy as np

    names = [f"ego_{i:02d}.npy" for i in range(VIDEO_FILES)]
    write_npy_videos(root, names, EGO_VIDEO_FRAMES, 224, 224, seed)
    verbs = ["cut", "wash", "open", "close", "take", "put", "stir", "pour"]
    nouns = ["onion", "knife", "fridge", "pan", "tap", "lid", "bowl", "cup"]
    meta = [dict(video=n, caption=f"{verbs[i % 8]} the {nouns[(3 * i) % 8]}")
            for i, n in enumerate(names)]
    with open(os.path.join(root, "meta.json"), "w") as f:
        json.dump(meta, f)
    labels = np.random.default_rng(seed).integers(0, 3806, VIDEO_FILES)
    with open(os.path.join(root, "train.csv"), "w") as f:
        f.writelines(f"{n} {l}\n" for n, l in zip(names, labels))


def run_cli_ego_video():
    """The CLI's egocentric real-data modes on 16 ``.npy`` clips (32
    frames of 224²), one epoch each at batch 8: ego_ek100_mir (CLIP-
    TimeMamba-B, 16 frames, fp32 with TF32, K10 spatial attention; 12 K1
    + 12 K10 + 12 K2 a step, then the retrieval evaluation: 12 K1 + 12
    K10 a batch of 8 clips), ego_timemamba_pretrain (4 frames, the same a
    step) and ego_ek100_cls on a csv (ViViM-T, 3806 actions: 48 K3 with
    checkpoints + 48 K4 a step, then evaluate: 48 K3 a batch). Returns
    the launches."""
    import tempfile

    from video_mamba_suite_torch.data.video_datasets import (
        VideoCaptionDataset,
        VideoClassificationDataset,
    )
    from video_mamba_suite_torch.tasks.egocentric import (
        ClipPretrainer,
        ClsFinetuner,
        MirFinetuner,
    )

    set_tf32(True)
    launches = collections.Counter()
    clip_eval = {k: v * (VIDEO_FILES // VIDEO_BATCH)
                 for k, v in CLIP_STEP_LAUNCHES.items()
                 if k != "short_bidir_bwd"}
    cls_eval = {"chunked_scan_fwd": VIVIM_LAUNCHES
                * (VIDEO_FILES // VIDEO_BATCH)}
    with tempfile.TemporaryDirectory(prefix="ego-video-") as root:
        write_ego_dataset(root, seed=1)
        meta = [f"dataset.metadata_json={root}/meta.json",
                f"dataset.video_root={root}",
                f"loader.batch_size={VIDEO_BATCH}"]
        for tag, preset, dataset, trainer, per_step, extra, sets, tail in (
                ("cli-ego-mir", "ego_ek100_mir", VideoCaptionDataset,
                 MirFinetuner, CLIP_STEP_LAUNCHES, clip_eval, meta,
                 r"'avg_map': ([0-9.eE+-]+)"),
                ("cli-ego-pretrain", "ego_timemamba_pretrain",
                 VideoCaptionDataset, ClipPretrainer, CLIP_STEP_LAUNCHES,
                 {}, meta, None),
                ("cli-ego-cls", "ego_ek100_cls", VideoClassificationDataset,
                 ClsFinetuner, VIVIM_STEP, cls_eval,
                 [f"dataset.csv_path={root}/train.csv",
                  f"dataset.video_root={root}",
                  f"loader.batch_size={VIDEO_BATCH}"],
                 r"'action_top1': ([0-9.eE+-]+)")):
            argv = ["egocentric", "--preset", preset, "--epochs", "1",
                    "--set"] + sets
            counts, out, _ = video_cli_phase(tag, argv, dataset, trainer,
                                             per_step, extra)
            if tail is not None:
                value = _first_number(tail, out)
                log(f"[{tag}] {tail.split(':')[0]} {value}")
                if not math.isfinite(value):
                    raise AssertionError(f"{tag}: {out[-300:]}")
            launches.update(counts)
    return dict(launches)


def rov_video(root, seed=0):
    """A 60 s ``.npy`` video (1800 frames of 128 x 170 at 30 fps)."""
    path = os.path.join(root, "video.npy")
    write_npy_videos(root, ["video.npy"], ROV_FRAMES, ROV_HEIGHT, ROV_WIDTH,
                     seed)
    return path


def rov_pipeline(device, depth=None, seed=0):
    """VTG's run-on-video pieces on ``device``: a ``VtgFeatureExtractor``
    at CLIP ViT-B/32's widths with a word tokenizer of the query, and
    UniVTG-Mamba at the QVHighlights preset's widths (video 512 + 2
    temporal endpoint features, text 512); random weights from ``seed``,
    towers and model cut to ``depth`` where given."""
    from video_mamba_suite_torch.configs import VTG_QVHIGHLIGHTS
    from video_mamba_suite_torch.data.tokenizer import WordTokenizer
    from video_mamba_suite_torch.tasks.vtg import (
        VtgFeatureExtractor,
        build_vtg_trainer,
    )

    image, text = dict(ROV_IMAGE), dict(ROV_TEXT)
    kw = {}
    if depth is not None:
        image["layers"] = text["layers"] = kw["depth"] = depth
    ex = VtgFeatureExtractor(
        image_cfg=image, text_cfg=text,
        tokenizer=WordTokenizer(corpus=[ROV_QUERY], context_length=77),
        device=device, seed=seed)
    model = build_vtg_trainer(VTG_QVHIGHLIGHTS, device=device, seed=seed,
                              txt_dim=512, vid_dim=514, **kw).model
    return ex, model


def run_vtg_run_on_video():
    """UniVTG's run-on-video on the card: ``VtgFeatureExtractor`` (CLIP
    ViT-B/32: image 224, patch 32, width 768, 12 layers; text 77 x 512, 12
    layers; fp32) on a 60 s ``.npy`` video of 128 x 170 (30 clips of 2 s)
    and ``ground_video`` with the QVHighlights preset's model (DBM, width
    1024, 6 layers; the 30 clips padded to 75 with 32 query tokens, so
    each layer scans 107 steps: 2 K3 a layer, no checkpoints). Returns the
    launches."""
    import tempfile

    import torch
    from video_mamba_suite_torch.ops import LAUNCHES, reset_launches
    from video_mamba_suite_torch.tasks.vtg import ground_video

    set_tf32(True)
    t0 = time.perf_counter()
    ex, model = rov_pipeline("cuda")
    log(f"[vtg-run-on-video] extractor and model built in "
        f"{time.perf_counter() - t0:.1f} s")
    want = {"chunked_scan_fwd": 2 * VTG_LAYERS}
    with tempfile.TemporaryDirectory(prefix="rov-") as root:
        path = rov_video(root)
        ground_video(ex, model, path, ROV_QUERY)          # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        feats = ex.video_features(path)
        t1 = time.perf_counter()
        reset_launches()
        with count_plain_calls() as plain, count_checkpoint_writes() as ck:
            t2 = time.perf_counter()
            out = ground_video(ex, model, path, ROV_QUERY)
            t3 = time.perf_counter()
        launches = dict(LAUNCHES)
    windows = out["pred_relevant_windows"]
    if feats.shape != (ROV_FRAMES // 60, 512) or launches != want or \
            sum(plain.values()) or ck["chunked_scan_fwd with checkpoints"] \
            or len(out["pred_saliency_scores"]) != ROV_FRAMES // 60 or \
            len(windows) != 5 or not all(
                math.isfinite(v) for w in windows for v in w):
        raise AssertionError(f"vtg-run-on-video: features {feats.shape}, "
                             f"launches {launches} (want {want}), plain "
                             f"versions {dict(plain)}, windows {windows}")
    log(f"[vtg-run-on-video] on {card_line()}: video features "
        f"{1e3 * (t1 - t0):.2f} ms ({feats.shape[0]} frames: decode, resize, "
        f"ViT-B/32), ground_video {1e3 * (t3 - t2):.2f} ms in all (its own "
        f"features, the query's, the model); launches {launches}; top "
        f"window {windows[0]}")
    return launches


def card_against_cpu_video():
    """The device stages card against CPU in fp32 (TF32 off):
    ``preprocess_clip``'s train mode at fixed offsets and flip on 16
    frames of 256 x 340 to 224², and one ``ground_video`` at the
    run-on-video phase's widths cut to depth 2 (towers and model, the
    same weights on both): the windows in the same order, their spans
    (fractions of the duration) and the saliency (against its largest
    magnitude) within 1e-4."""
    import tempfile

    import numpy as np
    from video_mamba_suite_torch.data import video
    from video_mamba_suite_torch.tasks.vtg import ground_video

    set_tf32(False)
    frames = np.random.default_rng(3).integers(
        0, 256, PREPROCESS_CLIP_SHAPE + (3,), dtype=np.uint8)
    args = (224, True, 20, 31, True, video.CLIP_MEAN, video.CLIP_STD)
    got = video._preprocess_clip_at(frames, *args, "cuda").cpu().numpy()
    want = video._preprocess_clip_at(frames, *args, "cpu").numpy()
    err = float(np.abs(got - want).max())
    log(f"[card-vs-cpu-video] preprocess_clip {PREPROCESS_CLIP_SHAPE} -> "
        f"224² (train, top 20, left 31, flipped): max |card - CPU| "
        f"{err:.3g} (tolerance {CARD_CPU_PREPROCESS_TOL})")
    if got.shape != (16, 224, 224, 3) or not err <= CARD_CPU_PREPROCESS_TOL:
        raise AssertionError(f"preprocess_clip card vs CPU: {err}")

    cpu_ex, cpu_model = rov_pipeline("cpu", depth=ROV_DEPTH, seed=5)
    ex, model = rov_pipeline("cuda", depth=ROV_DEPTH, seed=5)
    for dst, src in ((ex.image_tower, cpu_ex.image_tower),
                     (ex.text_tower, cpu_ex.text_tower), (model, cpu_model)):
        dst.load_state_dict(src.state_dict())
    with tempfile.TemporaryDirectory(prefix="rov-") as root:
        path = rov_video(root, seed=4)
        card = ground_video(ex, model, path, ROV_QUERY, top_k=30)
        cpu = ground_video(cpu_ex, cpu_model, path, ROV_QUERY, top_k=30)
    g, w = (np.asarray(r["pred_relevant_windows"]) for r in (card, cpu))
    duration = 2.0 * (ROV_FRAMES // 60)
    span_err = float(np.abs(g[:, :2] - w[:, :2]).max() / duration)
    prob_err = float(np.abs(g[:, 2] - w[:, 2]).max())
    sg, sw = (np.asarray(r["pred_saliency_scores"]) for r in (card, cpu))
    sal_err = float(np.abs(sg - sw).max() / np.abs(sw).max())
    # the windows rank the clips alike where each rank's span agrees
    log(f"[card-vs-cpu-video] ground_video at depth {ROV_DEPTH} on "
        f"{card_line()}: {len(g)} windows by rank: span error "
        f"{span_err:.3g} of the duration, probability error "
        f"{prob_err:.3g}, saliency error {sal_err:.3g} of its scale "
        f"(tolerance {CARD_CPU_ROV_TOL})")
    if g.shape != w.shape or not (span_err <= CARD_CPU_ROV_TOL and
                                  prob_err <= CARD_CPU_ROV_TOL and
                                  sal_err <= CARD_CPU_ROV_TOL):
        raise AssertionError("ground_video card vs CPU")
    set_tf32(True)


PHASES = {"mir-train": run_mir_train, "pretrain": run_clip_pretrain,
          "cls": run_ek100_cls, "lm-int8": run_lm_int8,
          "lm-loglik": run_lm_loglik,
          "card-vs-cpu-mir": card_against_cpu_mir_step,
          "card-vs-cpu-int8": card_against_cpu_lm_int8,
          "tas-gtea": run_tas_gtea, "tas-50salads": run_tas_50salads,
          "ckpt-mir": run_ckpt_mir, "card-vs-cpu-tas": card_against_cpu_tas,
          "vtg-qvhl": run_vtg_qvhl, "vtg-tvsum": run_vtg_tvsum,
          "vtg-vlp-qfvs": run_vtg_vlp_qfvs,
          "card-vs-cpu-vtg": card_against_cpu_vtg,
          "dvc-anet": run_dvc_anet, "dvc-yc2": run_dvc_yc2,
          "dvc-synthetic": run_dvc_synthetic,
          "card-vs-cpu-dvc": card_against_cpu_dvc,
          "cli-synthetic": run_cli_synthetic,
          "cli-tal-thumos": run_cli_tal_thumos,
          "card-vs-cpu-ckpt": card_against_cpu_ckpt,
          "cli-recognition-video": run_cli_recognition_video,
          "cli-ego-video": run_cli_ego_video,
          "vtg-run-on-video": run_vtg_run_on_video,
          "card-vs-cpu-video": card_against_cpu_video}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--routes"]:    # check_fresh_routes's child
        fresh_routes(sys.argv[2:])
        return 0
    from video_mamba_suite_torch.ops import _build

    if sys.argv[1:2] == ["--phases"]:    # a few phases alone, no result
        log(f"[device] {card_line()}")
        _build.build_all()
        for name in sys.argv[2:]:
            PHASES[name]()
        return 0

    card = card_line()
    log(f"[device] {card}; torch {torch.__version__} CUDA "
        f"{torch.version.cuda}")

    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"[build] kernels built in {time.perf_counter() - t0:.1f} s "
        f"(one nvcc per source, in parallel)")
    for name in built:
        for line in _build.build_log(name).splitlines():
            if any(w in line for w in ("registers", "spill", "smem",
                                       "stack frame")):
                log(f"[build] {name}: {line.strip()}")
    for name in built:
        for kernel, regs, stores, loads in kernel_resources(
                _build.build_log(name)):
            log(f"[build] {name}: kernel {kernel}: {regs} registers, "
                f"{stores} bytes spill stores, {loads} bytes spill loads")

    k1 = check_k1()
    k2 = check_k2()
    k3 = check_k3()
    k4 = check_k4()
    mark("K1-K4 cases")
    k5 = check_k5()
    k6 = check_k6()
    k10 = check_attention("K10", K10_CASES)
    k9 = check_attention("K9", K9_CASES)
    k11, k11_bwd = check_k11()
    k7 = check_k7()
    k8 = check_k8()
    mark("K5-K11 cases")
    check_fresh_routes("K5", "K6")
    check_fresh_routes("K7", "K8")
    mark("fresh routes")
    run_main_path()
    launches = run_train_step()
    mark("TimeMamba-B")
    launches.update(run_vivim_serving())
    launches.update(run_vivim_finetune())
    mark("ViViM-T")
    launches.update(run_lm_serving())
    mark("Mamba-130M")
    run_anticipation_streaming(run_anticipation_serving())
    launches["short_scan_bwd"] = run_anticipation_train()["short_scan_bwd"]
    mark("anticipation")
    launches["row_mha_fwd"] = run_mir_serving()["row_mha_fwd"]
    mark("MIR serving")
    card_against_cpu()
    card_against_cpu_grads()
    card_against_cpu_vivim()
    card_against_cpu_vivim_grads()
    card_against_cpu_lm()
    card_against_cpu_anticipation()
    card_against_cpu_clip()
    mark("card against CPU")
    launches.update(run_flash_module())
    # no model sets flash="vmem": K9's launches are its entry point's
    launches.update(run_vmem_module())
    launches.update(run_complex_scan())
    mark("flash, vmem, complex")
    # ActionMamba: THUMOS-14 and ActivityNet train steps, the THUMOS eval;
    # their scan launches add to the other paths'
    from video_mamba_suite_torch.configs import TAL_ANET, TAL_THUMOS

    thumos, tal = run_tal_train("thumos", TAL_THUMOS, TAL_THUMOS_LAUNCHES)
    run_tal_eval(thumos, TAL_THUMOS)
    del thumos
    _, anet = run_tal_train("anet", TAL_ANET, TAL_ANET_LAUNCHES)
    for name, count in list(tal.items()) + list(anet.items()):
        launches[name] += count
    card_against_cpu_tal()
    mark("ActionMamba")
    # the egocentric training paths and the rest of the LM; their launches
    # add to the other paths'
    for name in ("mir-train", "pretrain", "cls", "lm-int8", "lm-loglik"):
        for kernel, count in PHASES[name]().items():
            launches[kernel] += count
        mark(name)
    card_against_cpu_mir_step()
    card_against_cpu_lm_int8()
    mark("card against CPU, PR 16")
    # temporal action segmentation and upstream checkpoints; their launches
    # add to the other paths'
    for name in ("tas-gtea", "tas-50salads", "ckpt-mir"):
        for kernel, count in PHASES[name]().items():
            launches[kernel] += count
        mark(name)
    card_against_cpu_tas()
    mark("card-vs-cpu-tas")
    # video temporal grounding; its launches add to the other paths'
    for name in ("vtg-qvhl", "vtg-tvsum", "vtg-vlp-qfvs"):
        for kernel, count in PHASES[name]().items():
            launches[kernel] += count
        mark(name)
    card_against_cpu_vtg()
    mark("card-vs-cpu-vtg")
    # dense video captioning; its launches add to the other paths'
    for name in ("dvc-anet", "dvc-yc2", "dvc-synthetic"):
        for kernel, count in PHASES[name]().items():
            launches[kernel] += count
        mark(name)
    card_against_cpu_dvc()
    mark("card-vs-cpu-dvc")
    # the task CLI; its launches in this process add to the other paths'
    for name in ("cli-synthetic", "cli-tal-thumos"):
        for kernel, count in PHASES[name]().items():
            launches[kernel] += count
        mark(name)
    card_against_cpu_ckpt()
    mark("card-vs-cpu-ckpt")
    # the video data stack: the CLI's raw-video modes and VTG's
    # run-on-video; their launches add to the other paths'
    for name in ("cli-recognition-video", "cli-ego-video",
                 "vtg-run-on-video"):
        for kernel, count in PHASES[name]().items():
            launches[kernel] += count
        mark(name)
    card_against_cpu_video()
    mark("card-vs-cpu-video")

    kernels = [dict(
        name=name, route="cuda", source=source, replaces=replaces,
        launches=launches[name], max_abs_err=k["max_abs_err"], ms=k["ms"],
        plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
        bound_by=k["bound_by"], library_ms=k.get("library_ms"))
        for name, source, replaces, k in (
            ("short_bidir_fwd", K1_SOURCE, K1_REPLACES, k1),
            ("short_bidir_bwd", K2_SOURCE, K2_REPLACES, k2),
            ("chunked_scan_fwd", K3_SOURCE, K3_REPLACES, k3),
            ("chunked_scan_bwd", K4_SOURCE, K4_REPLACES, k4),
            ("short_scan_fwd", K5_SOURCE, K5_REPLACES, k5),
            ("short_scan_bwd", K6_SOURCE, K6_REPLACES, k6),
            ("complex_scan_fwd", K7_SOURCE, K7_REPLACES, k7),
            ("complex_scan_bwd", K8_SOURCE, K8_REPLACES, k8),
            ("vision_mha_fwd", K9_SOURCE, K9_REPLACES, k9),
            ("row_mha_fwd", K10_SOURCE, K10_REPLACES, k10),
            ("flash_mha_fwd", K11_SOURCE, K11_REPLACES, k11),
            ("flash_mha_bwd", K11_SOURCE, K11_BWD_REPLACES, k11_bwd))]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
