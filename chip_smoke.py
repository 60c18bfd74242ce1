#!/usr/bin/env python3
"""Smoke run of cream_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, one or more lines each (any failure raises, so the script exits
non-zero):
  1. device: requires CUDA; prints the card's name and power limit
  2. build: compiles the CUDA kernels from csrc/ into build/
  3. K1 vs plain: the window-attention forward kernel against
     `window_attention_ref` on the card, bf16 (tensor cores) and fp32 (CUDA
     cores), at TinyViT-21M-224's three stage shapes (bs256),
     TinyViT-21M-384's two 144-token stages (bs64), a Swin-T stage-0
     qkv_major + shift-mask case and S3-Tiny bs128's four stages (qkv_major,
     the shift mask at stages 0 and 1); kernel and one-call library (SDPA;
     bias plus mask as one attn_mask) device times by CUDA-graph replay
     with their CUDA-events times beside them, plain times, per stage and
     summed over a TinyViT-21M-224 forward and an S3-Tiny forward; and at
     Swin-B bs256's four stages (qkv_major, the mask at stages 0-2), summed
     over its 2 + 2 + 18 + 2 blocks
  4. K2 vs plain: the backward kernel against `window_attention_bwd_ref` at
     the same shapes (Swin-B's untimed), bf16 and fp32; dqkv and dbias the
     same bits on two
     launches; kernel and library (SDPA backward: its fwd+bwd graph less
     its fwd graph, or CUDA events where that cannot be captured) times as
     for K1, summed over a train step, and the K1+K2 autograd.Function pair
     against SDPA forward+backward
  5. grads: at a small fp32 shape, the autograd.Function's grads against
     autograd of the plain forward
  6. golden: TinyViT-21M-224 fp32 on seeded weights against the JAX
     package's logits stored in tests/data/torch_port/
  7. train golden: one fp32 TinyViT-21M-224 train step (B=2) against the
     JAX package's loss and per-param grad norms stored beside them
  8. main path (eval): TinyViT-21M-224 bf16 at bs256 through
     cli.inference.predict and cli.speed_test.throughput, kernel path against
     the plain-attention path on the same weights
  9. main path (train): TinyViT-21M-224 bf16 at bs256 through
     train.make_train_step: 10 K1 + 10 K2 launches per step, the loss falls
     over 10 steps on one batch, kernel path against plain path on the same
     weights and batch, train img/s of both, peak memory
 9a. Swin goldens: s3_tiny, swin_tiny and mini_swin_tiny fp32 (B=2) on
     seeded weights against the JAX package's logits stored in
     tests/data/torch_port/ (12, 12 and 0 fp32 K1 launches), and one fp32
     s3_tiny train step against the JAX loss and per-param grad norms
 9b. main path (Swin eval): s3_tiny bf16 bs128 through predict and
     throughput: 12 K1 launches per forward, top-1 agreement and logits
     (8 bf16 ulps) against use_kernel=False, img/s of both routes in 4
     interleaved rounds; swin_tiny the same in one round; mini_swin_tiny
     (head transforms: the plain route, as in JAX) no K1, its img/s
 9c. main path (S3-Tiny train): s3_tiny bf16 bs128 through
     train.make_train_step: 12 K1 + 12 K2 launches per step, the loss falls
     over 10 steps on one batch, the first step against use_kernel=False,
     train img/s of both routes, peak memory
 9d. main path (TinyViT fast distillation), through the CLIs' main(argv)
     in a temporary directory under build/: cli.save_logits with a seeded
     Swin-B-22k teacher (bf16 bs256, 1,024 synthetic images, a seeded 1k ->
     22k mapping with 5 absent classes, top-100; 24 K1 launches a forward,
     the native codec, every stored seed sample_seed's, no absent class
     stored, teacher img/s and host ms per batch), its --check pass (value
     error <= 1e-3, tie-aware miss rate 0), cli.train with
     distill.enabled on TinyViT-21M-224 (bf16 bs256, mixup 0.8 / cutmix
     1.0: 10 K1 + 10 K2 launches a step, the stored seeds checked, finite
     loss), a store without recipe.json refused; the distill step alone
     (10 + 10 launches a step, img/s by CUDA events, peak memory), the fp32
     B=2 distill step against the JAX golden (loss 1e-4, grad norms 1e-3
     per tensor) and the bf16 step against the plain attention route (loss
     2 ulps, grad_norm 2%)
 9e. CLIP goldens (TinyCLIP's serving path: no TPU kernel lies on it, so
     it launches none): tinyclip_vit_39m_16_text_19m and clip_resnet50 fp32
     (B=2, TF32 off) on seeded weights against the JAX package's image
     features, text features and logit scale stored in
     tests/data/torch_port/ (1e-4); for the ViT CLIP also the pair under a
     0/1 gate set (hidden channels, heads, MLP channels, whole branches)
     and the ragged model `zoo.load.load_pruned_clip` builds from that
     gated state_dict pruned
 9f. main path (CLIP pairs): tinyclip_vit_39m_16_text_19m and clip_resnet50
     bf16 bs256 through cli.speed_test.pair_throughput (images and (B, 77)
     token ids, both towers consumed): pairs/s, peak memory, device time by
     kind of op from cli.profile_step.profile; bf16 features against fp32
     on the same inputs (cosine >= 0.999 a row) and each image's best text
     over the batch on rows whose fp32 top-2 margin is above 4 bf16 ulps
 9g. main path (zero-shot): cli.zero_shot.main on TinyCLIP-ViT-39M/16 in
     bf16 and fp32: 1,000 ImageNet names x 80 templates through a merges
     file learned from them, 1,024 synthetic images at bs256; the
     tokenizer's host seconds, the text and image passes' seconds,
     top-1/top-5; unit-norm classifier columns, bf16 against fp32 (cosine
     >= 0.999 a class)
 9h. main path (CLIP-L/14-22k teacher): cli.save_logits with
     clip_vit_large14_224_classifier, 21,841 classes, bf16 bs256, the
     seeded 1k -> 22k mapping, top-100, then --check (value error <= 1e-3,
     tie-aware miss rate 0); the teacher's img/s
 9i. TinyCLIP train golden (TinyCLIP's training path: no TPU kernel lies on
     it either): one fp32 B=2 L0 distillation step of TinyCLIP-39M/16 (TF32
     off; the stored uniforms for both towers' masks) against the JAX
     package's loss, grad norms and L0 grads stored in tests/data/torch_port/
     (loss and global grad norm 1e-4, per-tensor grad norms 1e-3, L0 grads
     1e-3 of their largest)
 9j. main path (TinyCLIP training): the L0 distillation step of
     TinyCLIP-39M/16 at bf16 bs256 through
     cli.speed_test.tinyclip_train_throughput with remat off and on
     (tinyclip_39m_train_throughput pairs/s, peak memory; the first loss the
     same within 2 bf16 ulps and less memory with remat), device time by
     kind of op from cli.profile_step.profile
 9k. 20 steps on one bs256 batch: the loss falls, both towers' expected
     sparsity rises toward the target; then prune_clip on the card: the
     trained student's fp32 features with its deterministic masks (a seeded
     quarter of each gate set pushed off) against the ragged model's (1e-4),
     params before and after
 9l. cli.tinyclip_pipeline.main --synthetic on cuda: two L0 stages at the
     JAX package's smoke size, each shrinking both towers
 9m. DeiT iRPE goldens (no TPU kernel lies on the DeiT / Mini-DeiT path):
     deit_small_patch16_224_ctx_product_50_shared_k,
     deit_tiny_patch16_224_ctx_product_50_shared_qkv and
     mini_deit_small_patch16_224 fp32 (B=2, TF32 off) on seeded weights
     against the JAX package's logits stored in tests/data/torch_port/
     (1e-3), and one fp32 B=2 DeiT-S iRPE-K train step against the JAX loss,
     per-tensor grad norms and rpe_k table grads stored beside them
 9n. main path (DeiT / Mini-DeiT eval): DeiT-S iRPE-K and Mini-DeiT-S bf16
     bs256 through cli.speed_test.throughput: img/s, peak memory, device
     time by kind of op (cli.profile_step.profile); bf16 vs fp32 top-1 on
     images whose fp32 top-2 margin is above 4 bf16 ulps
 9o. main path (DeiT / Mini-DeiT train): the same two at bf16 bs256, drop
     path 0.1: the loss falls over 20 steps on one batch; train img/s
     through cli.speed_test.train_throughput, peak memory, device time by
     kind (the iRPE gather and its scatter-add backward named)
 9p. Mini-Swin-T bf16 bs128 with capture_distill: logits bit for bit those
     without capture; the count and shapes of the qkv and hidden states.
     No kernel launches in 9m-9p.
 10. K5 vs plain: the CGA attention-core kernel against `cga_attention_ref`,
     bf16 (tensor cores) and fp32 (CUDA cores), at EfficientViT-M5 bs512's
     and M0 bs1024's per-head shapes, bf16 the same bits on two launches;
     kernel, plain and one-call library (SDPA) device times by CUDA-graph
     replay, with their CUDA-events times beside them
 11. K4 vs plain: the fused CGA kernel against `fused_cga_ref` on a seeded
     module's fold at the same stage shapes, bf16 (tensor cores, several
     windows a block) and fp32 (CUDA cores); its launch plan against the
     library's; bf16 the same bits on two launches and at 1, 3 and G + 1
     windows (the last block short); kernel, plain and unfused
     "plain"-route module device times by CUDA-graph replay in 3
     interleaved rounds (CUDA events beside them; no single library call
     computes the cascade), per stage and summed per M5 and M0 forward
 12. EfficientViT golden: M5 fp32 on seeded weights against the JAX
     package's logits stored in tests/data/torch_port/, on each of the
     three attention routes
 13. main path (EfficientViT eval): M5 bf16 bs512 and M0 bf16 bs1024
     through cli.inference.predict and cli.speed_test.throughput: the
     default "cascade" route (one K4 launch per attention block), the
     "core" route (one K5 launch per head) and the "plain" route on the same
     weights; top-1 agreement and logits against "plain"; img/s of the
     three routes, interleaved; then each route's whole forward by
     CUDA-graph replay (the folds warmed first), 3 interleaved rounds
 14. K7/K8/K9 vs plain: the depthwise 3x3 kernels against their plain
     versions, bf16 and fp32, at EfficientViT-M5 bs512's depthwise sites,
     TinyViT-21M bs256's MBConv, local_conv and PatchMerging sites, three
     odd stride-2 maps and Cream's 19 site shapes at bs128 (`models.cream.
     dw3x3_sites`); dx and dw the same bits on two launches; kernel,
     plain, library (cuDNN) and bound times per model site by CUDA-graph
     replay, K9's backward (a tile kernel) on a line of its own per site
     with its plan, summed per M5 train step and per TinyViT-21M-224 train
     step
 15. grads: at a small fp32 shape, each depthwise autograd.Function's grads
     against autograd of the plain forward
 16. EfficientViT train golden: one fp32 M5 train step (B=8) on each
     depthwise route against the JAX package's loss and per-param grad
     norms stored in tests/data/torch_port/
 17. main path (EfficientViT train): M5 bf16 bs512 through
     train.make_train_step on each depthwise route ("library", "fused",
     "wgrad"): K7/K8/K9 launches per step from the site count, no K4/K5;
     the loss falls over 10 steps on one batch; kernel routes against
     "library" on the same weights and batch; train img/s of the three
     routes interleaved, peak memory; M5 bs512 eval img/s with the
     depthwise convs on "library" and "fused"
 18. main path (TinyViT train, depthwise routes): TinyViT-21M-224 bf16
     bs256 through train.make_train_step with every depthwise ConvBN on
     "library" and on "fused": 12 + 12 K7 and 3 + 3 K9 launches per step
     on "fused", none on "library"; the first step's loss and grad norm
     against "library"; train img/s of both routes in 4 interleaved rounds
 19. K6 vs plain: the fused eval MBConv kernel against `fused_mbconv_ref` on
     a seeded module's fold at TinyViT-21M's and -5M/11M's stage-0 shapes
     (bs256 bf16; fp32 at bs32) and at maps its 14x14 bf16 tiles cut
     raggedly, the same bits on two launches; kernel, plain and
     unfused-module device times by CUDA-graph replay in 3 interleaved
     rounds (CUDA events beside them) against the roofline bound and the
     CUDA-core floor
 20. K3 vs plain: the bias-attention kernel against
     `fused_bias_attention_ref` at TinyViT-21M's per-window shapes (bs256)
     and a 16-token window, bf16 (tensor cores; the same bits on two
     launches) and fp32 (CUDA cores); kernel, plain and SDPA times as for
     K5; then `BiasAttention` at 4,096 windows of 49 tokens, dim 192, 6
     heads: one K3 launch per call, against its plain route
 21. K10 vs plain: the window partition and reverse kernels at
     TinyViT-21M-384's stage-2 map (bs64, window 24) and TinyViT-21M-224's
     stage-1 map (bs256, window 7), bit for bit; kernel, plain and
     `permute().contiguous()` device times (CUDA graphs)
 22. K11 vs plain: the layout-pin copy at TinyViT-21M bs256's three
     stage-boundary tensors, bit for bit; kernel and `x.clone()` device
     times (CUDA graphs); then K11 per forward against x.clone() and K9's
     forward and backward per TinyViT-21M-224 train step against cuDNN, by
     CUDA-graph replay in 3 interleaved rounds, each round's ratio
 23. main path (TinyViT eval routes): TinyViT-21M-224 bf16 bs256 through
     cli.inference.predict and cli.speed_test.throughput on four routes —
     library, mbconv_kernel (2 K6 launches per forward), pin_layouts (3 K11
     launches, logits bit-identical to library), both; top-1 agreement of
     the K6 route with library; img/s interleaved; the fp32 golden with
     both routes on
 9q. AutoFormer goldens: autoformer_supernet_tiny fp32 B=2 at the smallest,
     largest and a sampled config against the JAX logits stored in
     tests/data/torch_port/ (1e-3), extract_subnet against the supernet
     (1e-5 of the largest |logit|), one fp32 supernet train step against the
     JAX loss and per-tensor grad norms, every grad outside the config 0
 9r. AutoFormer-T supernet training bf16 bs128: cli.supernet_train.main
     (one short epoch into build/), then 3 + 10 steps at sampled configs
     (img/s median, min, max; the largest config's; peak memory), the loss
     falls over 20 steps at the largest config, one model object throughout
 9s. evolution search (BASELINE.json configs[3]): cli.search_evolution.main
     on 9r's checkpoint, 1,024 synthetic images at bf16 bs256, population 16,
     2 epochs, window 5-6 M: candidates/s, eval img/s; the best config's
     AutoFormerSubnet img/s and its top-1 against the supernet
 9t. Cream childnets: cream_604 (224) and cream_14 (64) fp32 goldens,
     cream_604 bf16 bs256 img/s, cream_481 on "fused" (K7/K9 at its k3 sites)
     against "library"; no depthwise site refused
 9u. Cream search: cli.search_cream.main at 224, then the supernet train
     step bf16 bs128 on "library" and "fused" over one seeded path sequence
     (K7/K9 launches per step, loss and grad norm between routes, img/s,
     peak memory, the meta step's ms); no depthwise site refused
 24. main path (TinyViT-21M-384 eval): bf16 bs64, stage 2's 24x24 window
     through forward_windowed: 12 K10 launches per forward, logits bit for
     bit equal to the same forward with K10's two functions swapped for
     their plain versions, top-1 agreement with the all-plain model; img/s
 25. train check: one TinyViT-21M-224 bf16 bs256 train step with
     pin_layouts on: 3 K11 launches (none in the backward), the loss bit for
     bit the unpinned step's, per-tensor grads no further from it than a
     second unpinned step is
The total wall time is printed, then the card, then a JSON summary of the
kernels (K1/K2 rows with an `s3_tiny` sum beside TinyViT's, K1's with a
`swin_base` sum); the last line
is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import copy
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from cream_tpu_torch.cli.inference import predict  # noqa: E402
from cream_tpu_torch.cli.speed_test import (card_info, throughput,  # noqa: E402
                                            train_throughput)
from cream_tpu_torch.models import create_model  # noqa: E402
from cream_tpu_torch.models.clip import prune_clip, prune_clip_state_dict  # noqa: E402
from cream_tpu_torch.models.cream import dw3x3_path_sites, dw3x3_sites  # noqa: E402
from cream_tpu_torch.models.efficientvit import CascadedGroupAttention  # noqa: E402
from cream_tpu_torch.nn.attention import BiasAttention, WindowBiasAttention  # noqa: E402
from cream_tpu_torch.nn.swin import SwinWindowAttention  # noqa: E402
from cream_tpu_torch.nn.layers import (DW_REFUSED, ConvBN, MBConv, set_dw_kernel,  # noqa: E402
                                       set_mbconv_kernel)
from cream_tpu_torch.ops import (bias_attention, build, cga, cga_core, dwconv,  # noqa: E402
                                 layout_pin, mbconv, window_relayout)
from cream_tpu_torch.ops import window_attention as wa  # noqa: E402
from cream_tpu_torch.ops.window import window_partition  # noqa: E402
from cream_tpu_torch.train import TrainState, make_adamw, make_train_step  # noqa: E402
from cream_tpu_torch.train.losses import soft_target_ce  # noqa: E402
from cream_tpu_torch.train.optim import global_norm  # noqa: E402
from cream_tpu_torch.train.steps import loss_and_grads, step_generator  # noqa: E402
from cream_tpu_torch.zoo.load import seeded_state_dict  # noqa: E402

DATA = ROOT / "tests" / "data" / "torch_port"
GOLDEN = DATA / "tinyvit_21m_224_seed0.npz"
TRAIN_GOLDEN = DATA / "tinyvit_21m_224_train_seed0.npz"
EVIT_GOLDEN = DATA / "efficientvit_m5_seed0.npz"
EVIT_TRAIN_GOLDEN = DATA / "efficientvit_m5_train_seed0.npz"
BATCH = 256
# NVIDIA H100 SXM data-sheet peaks (dense): HBM bytes/s, bf16 and fp32
# tensor-core FLOP/s (TF32 for fp32 inputs)
HBM_BPS = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 495e12}
# (name, B, map, window, heads, kd=dv, blocks per TinyViT-21M forward)
TINYVIT_SHAPES = [("stage1", BATCH, 28, 7, 6, 32, 2),
                  ("stage2", BATCH, 14, 14, 12, 32, 6),
                  ("stage3", BATCH, 7, 7, 18, 32, 2)]
# S3-Tiny bs128's K1/K2 shapes (bench.py:553, :573), qkv_major: (name, B,
# map, window, heads, head dim, shift mask, blocks per forward). Stages 0
# and 1 alternate unshifted and shifted blocks; both are timed at the
# shifted block's time. Stages 2 and 3 are one window a map: no shift.
S3T_BATCH = 128
S3T_SHAPES = [("s3t_stage0", S3T_BATCH, 56, 7, 3, 32, True, 2),
              ("s3t_stage1", S3T_BATCH, 28, 7, 6, 32, True, 2),
              ("s3t_stage2", S3T_BATCH, 14, 14, 12, 32, False, 6),
              ("s3t_stage3", S3T_BATCH, 7, 7, 24, 32, False, 2)]
# Swin-B bs256's K1 shapes (the distillation teacher, save_logits at 224),
# qkv_major: (name, B, map, window, heads, head dim, shift mask, blocks per
# forward). Stages 0-2 alternate unshifted and shifted blocks (window 7,
# shift 3), timed at the shifted block's time; stage 3 is one window a map.
SWINB_BATCH = 256
SWINB_SHAPES = [("swinb_stage0", SWINB_BATCH, 56, 7, 4, 32, True, 2),
                ("swinb_stage1", SWINB_BATCH, 28, 7, 8, 32, True, 2),
                ("swinb_stage2", SWINB_BATCH, 14, 7, 16, 32, True, 18),
                ("swinb_stage3", SWINB_BATCH, 7, 7, 32, 32, False, 2)]
# TinyViT-21M-384 bs64's K1 shapes (window 12, 144 tokens; stage 2's
# 576-token window takes the plain attention): correctness and times only
TINYVIT384_SHAPES = [("384_stage1", 64, 48, 12, 6, 32, 2),
                     ("384_stage3", 64, 12, 12, 18, 32, 2)]
# EfficientViT main paths: (model, batch) and each attention stage at 224 as
# (name, windows, ws, C, heads, per-head depthwise kernels, blocks per forward)
EVIT_PATHS = [("efficientvit_m5", 512), ("efficientvit_m0", 1024)]
EVIT_STAGES = {
    "efficientvit_m5": [("m5_s0", 2048, 7, 192, 3, (7, 5, 3), 1),
                        ("m5_s1", 512, 7, 288, 3, (7, 5, 3), 3),
                        ("m5_s2", 512, 4, 384, 4, (7, 5, 3, 3), 4)],
    "efficientvit_m0": [("m0_s0", 4096, 7, 64, 4, (5, 5, 5, 5), 1),
                        ("m0_s1", 1024, 7, 128, 4, (5, 5, 5, 5), 2),
                        ("m0_s2", 1024, 4, 192, 4, (5, 5, 5, 5), 3)],
}
KD = 16
# the depthwise 3x3 sites of one EfficientViT-M5 bs512 train step at 224
# and of one TinyViT-21M-224 bs256 train step (its 2 MBConv conv2 and 10
# local_conv sites at stride 1, 3 PatchMerging sites at stride 2):
# (name, B, H, W, C, stride, sites per step)
DW_M5 = [("m5_s0_block", 512, 14, 14, 192, 1, 3), ("m5_s0_cga", 2048, 7, 7, 16, 1, 1),
         ("m5_s1_block", 512, 7, 7, 288, 1, 8), ("m5_s1_cga", 512, 7, 7, 16, 1, 3),
         ("m5_s2_block", 512, 4, 4, 384, 1, 9), ("m5_s2_cga", 512, 4, 4, 16, 1, 8),
         ("m5_merge0", 512, 14, 14, 768, 2, 1)]
DW_TINYVIT = [("tv21m_mbconv", 256, 56, 56, 384, 1, 2), ("tv21m_local_s1", 256, 28, 28, 192, 1, 2),
              ("tv21m_local_s2", 256, 14, 14, 384, 1, 6), ("tv21m_local_s3", 256, 7, 7, 576, 1, 2),
              ("tv21m_merge0", 256, 56, 56, 192, 2, 1), ("tv21m_merge1", 256, 28, 28, 384, 2, 1),
              ("tv21m_merge2", 256, 14, 14, 576, 2, 1)]
# stride-2 maps K9's backward cuts raggedly (dx rows or columns past H or
# W, dy taps past Ho or Wo), checked but not timed
DW_S2_ODD = [("s2_odd_7x7", 2, 7, 7, 16, 2, 0), ("s2_odd_8x6_c15", 3, 8, 6, 15, 2, 0),
             ("s2_odd_9x13", 2, 9, 13, 24, 2, 0)]
DW_ROUTES = ("library", "fused", "wgrad")
# K6 sites: TinyViT-21M's stage-0 MBConv (2 per forward) and TinyViT-5M/11M's
# (name, B, H, W, C, HID, per forward)
MBCONV_SHAPES = [("tv21m_stage0", BATCH, 56, 56, 96, 384, 2),
                 ("tv5m_stage0", BATCH, 56, 56, 64, 256, 2)]
# maps that K6's bf16 tiles (14x14) cut raggedly, checked but not timed
K6_RAGGED = [("ragged_15x15", 2, 15, 15, 32, 64, 0), ("ragged_57x35", 1, 57, 35, 64, 256, 0),
             ("one_pixel", 2, 1, 1, 96, 384, 0), ("ragged_30x23", 3, 30, 23, 96, 384, 0)]
# the CUDA-core floor's rates at an assumed 1.98 GHz (the clock at which the
# data sheet's 67 TFLOP/s fp32, an FMA as 2, holds; not read from the card):
# one fp32 operation a lane a clock on 132 SMs x 128 lanes, and one MUFU
# operation (ex2, rcp) on 16 of each SM's lanes a clock (the CUDA C++
# Programming Guide's throughput table, compute capability 9.0)
CUDA_CORE_CLOCK = 1.98e9
CUDA_CORE_OPS = 132 * 128 * CUDA_CORE_CLOCK
MUFU_OPS = 132 * 16 * CUDA_CORE_CLOCK
# K3: (name, windows, heads, N, d); the first is BiasAttention's main path
K3_SHAPES = [("tv21m_s1_windows", 4096, 6, 49, 32), ("tv21m_s3_windows", BATCH, 18, 49, 32),
             ("tv21m_s2_windows", BATCH, 12, 196, 32), ("evit_4x4_windows", 4096, 4, 16, 16)]
# K10: (name, B, map, window, C, launches per forward of TinyViT-21M-384)
K10_SHAPES = [("tv21m384_stage2", 64, 24, 24, 384, 12), ("tv21m224_stage1", BATCH, 28, 7, 192, 0)]
# K11: TinyViT-21M bs256's stage-boundary tensors (B, map, C)
K11_SHAPES = [("stage1_in", BATCH, 28, 192), ("stage2_in", BATCH, 14, 384),
              ("stage3_in", BATCH, 7, 576)]
TV_ROUTES = ("library", "mbconv_kernel", "pin_layouts", "both")


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def bound(dtype: torch.dtype, ref: torch.Tensor) -> float:
    """Max-abs bound of kernel vs plain: bf16, two ulps at the largest |out|
    (P and the output each round to bf16, and sums run in other orders);
    fp32, 1e-5 relative to the largest |out| (fp32 sums in other orders)."""
    top = max(1.0, ref.abs().max().item())
    if dtype == torch.bfloat16:
        return 2.0 ** (np.floor(np.log2(top)) - 6)
    return 1e-5 * top


def cuda_ms(fn, iters: int = 10, reps: int = 5) -> float:
    """Median over `reps` of the mean time of `iters` calls, CUDA events."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def graph_ms(fn, iters: int = 10, reps: int = 5) -> float:
    """Device time of one call of `fn`: `iters` calls captured in one CUDA
    graph, the median over `reps` replays (CUDA events) over `iters`. The
    host's cost of issuing each call, which `cuda_ms` measures for a launch
    shorter than it, is out."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    del graph
    return statistics.median(times)


def shift_mask(H: int, W: int, ws: int, shift: int, device) -> torch.Tensor:
    """Swin's shifted-window additive mask, (nH*nW, N, N) with 0 / -100."""
    img = torch.zeros(H, W, device=device)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    win = img.view(H // ws, ws, W // ws, ws).permute(0, 2, 1, 3).reshape(-1, ws * ws)
    return (win[:, None, :] != win[:, :, None]).float() * -100.0


def k1_case(gen, B, H, ws, heads, d, dtype, layout="head_major", mask=False):
    L, N = heads * 3 * d, ws * ws
    dev = "cuda"
    qkv = torch.randn(B, H, H, L, generator=gen, device=dev).to(dtype)
    bias = torch.randn(heads, N, N, generator=gen, device=dev) * 0.5
    qb = torch.randn(L, generator=gen, device=dev) * 0.1
    m = shift_mask(H, H, ws, ws // 2, dev) if mask else None
    kw = dict(window=ws, heads=heads, kd=d, dv=d, layout=layout, qkv_bias=qb)
    return (qkv, bias, m), kw


def bound_ms(B, H, ws, heads, d, dtype, backward: bool,
             masked: bool = False) -> tuple[float, str]:
    """Least time the card could take for the work of K1 (forward) or K2
    (backward) at one stage shape: the larger of the bytes it must move
    (each input read once, each output written once) over HBM bandwidth and
    its products' FLOPs over the peak rate for the input type."""
    e = torch.finfo(dtype).bits // 8
    L, N, pix = heads * 3 * d, ws * ws, B * H * H
    windows = B * (H // ws) ** 2
    nbytes = pix * L * e + heads * N * N * 4 + L * e      # qkv, bias, qkv bias
    if masked:                                            # fp32 mask per window position
        nbytes += (H // ws) ** 2 * N * N * 4
    if backward:   # + dout; dqkv, dbias. Q.K^T, dP, dQ, dK, dV
        nbytes += pix * heads * d * e + pix * L * e + heads * N * N * 4
        flops = windows * heads * 2 * N * N * 5 * d
    else:          # out. Q.K^T and P.V
        nbytes += pix * heads * d * e
        flops = windows * heads * 2 * N * N * 2 * d
    return roofline_ms(nbytes, flops, dtype)


def roofline_ms(nbytes: float, flops: float, dtype: torch.dtype) -> tuple[float, str]:
    """The larger of `nbytes` over HBM bandwidth and `flops` over the peak
    rate for `dtype`, in ms, and which of the two it is."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sdpa_windows(qkv, bias, dout, kw, shift_mask=None):
    """The library call's operands: the bias-folded qkv (and dout, if given)
    partitioned into (windows, heads, N, d) and the bias as a float
    attn_mask in qkv's dtype, all leaves that take grads. With a shift mask
    the attn_mask is bias plus mask, one (windows, heads, N, N) tensor."""
    ws, h, d = kw["window"], kw["heads"], kw["kd"]
    x = qkv + kw["qkv_bias"].to(qkv.dtype)
    w = window_partition(x, ws)[0]
    q, k, v = (t.transpose(1, 2).contiguous().requires_grad_()
               for t in wa.split_qkv(w, kw["layout"], h, d, d))
    if shift_mask is None:
        mask = bias.to(qkv.dtype)[None]
    else:
        per_image = bias[None] + shift_mask[:, None]          # (nW, h, N, N)
        mask = per_image.to(qkv.dtype).repeat(q.shape[0] // shift_mask.shape[0], 1, 1, 1)
    mask = mask.contiguous().requires_grad_()
    if dout is None:
        return (q, k, v, mask), None
    do = window_partition(dout, ws)[0].unflatten(-1, (h, d)).transpose(1, 2).contiguous()
    return (q, k, v, mask), do


def k1_cases():
    """(name, B, map, window, heads, d, mask, layout) of the K1/K2 checks:
    TinyViT-21M-224's three stages, TinyViT-21M-384's two windowed stages,
    Swin-T's stage 0 (qkv_major with the shift mask), S3-Tiny bs128's
    four stages (qkv_major, the mask at stages 0 and 1) and Swin-B bs256's
    four (qkv_major, the mask at stages 0-2)."""
    cases = [(n, B, H, ws, h, d, False, "head_major")
             for n, B, H, ws, h, d, _ in TINYVIT_SHAPES + TINYVIT384_SHAPES]
    cases.append(("swin_t_stage0", 64, 56, 7, 3, 32, True, "qkv_major"))
    cases += [(n, B, H, ws, h, d, mask, "qkv_major")
              for n, B, H, ws, h, d, mask, _ in S3T_SHAPES + SWINB_SHAPES]
    return cases


def timed(name: str, backward: bool = False) -> bool:
    """Whether a K1 (K2) case is timed: the main paths' stage shapes; Swin-B
    (an eval-only teacher) for K1 only."""
    shapes = TINYVIT_SHAPES + TINYVIT384_SHAPES + S3T_SHAPES + ([] if backward else SWINB_SHAPES)
    return name in {n for n, *_ in shapes}


def capturable(fn) -> bool:
    """Whether fn can be captured in a CUDA graph: it is first run on a side
    stream, as a capture of autograd's backward needs, and a failed capture
    is tried once more."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    for attempt in range(2):
        try:
            graph_ms(fn, iters=1, reps=1)
            return True
        except RuntimeError as e:
            torch.cuda.synchronize()
            print(f"  (capture {attempt + 1} in a CUDA graph failed: "
                  f"{str(e).splitlines()[0][:120]})")
    return False


def graph_rounds(*fns, rounds: int = 3) -> list[list[float]]:
    """Each fn's `graph_ms` in each of `rounds` rounds, the fns timed in
    turn each round, so a drift of the card's clock falls on all of them."""
    times = [[] for _ in fns]
    for _ in range(rounds):
        for t, fn in zip(times, fns):
            t.append(graph_ms(fn))
    return times


def interleaved_graph_ms(*fns, rounds: int = 3) -> list[float]:
    """The median over `rounds` of each fn's `graph_ms` (`graph_rounds`)."""
    return [statistics.median(t) for t in graph_rounds(*fns, rounds=rounds)]


def kernel_plain_library_ms(kern, plain, lib) -> dict:
    """Device times of a kernel, its plain version and the one-call library
    yardstick by CUDA-graph replay, timed in turn (`interleaved_graph_ms`),
    with each one's CUDA-events time (`cuda_ms`, the host's issue included)
    beside it; under inference mode."""
    with torch.inference_mode():
        k_ms, p_ms, l_ms = interleaved_graph_ms(kern, plain, lib)
        return dict(ms=k_ms, host_ms=cuda_ms(kern), plain_ms=p_ms, plain_host_ms=cuda_ms(plain),
                    library_ms=l_ms, library_host_ms=cuda_ms(lib))


def format_times(t: dict) -> str:
    """A kernel_plain_library_ms dict (and its bound) as one phrase: device
    times by CUDA-graph replay, CUDA-events times in parentheses."""
    return (f"kernel {t['ms']:.4f} ms ({t['host_ms']:.4f} by CUDA events), plain "
            f"{t['plain_ms']:.4f} ({t['plain_host_ms']:.4f}), library {t['library_ms']:.4f} "
            f"({t['library_host_ms']:.4f}), bound {t['bound_ms']:.4f} ms ({t['bound_by']}); "
            f"kernel / library {t['ms'] / t['library_ms']:.2f}x, kernel / bound "
            f"{t['ms'] / t['bound_ms']:.1f}x")


def phase_k1(gen) -> tuple[float, dict]:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    worst_bf16, times = 0.0, {}
    for name, B, H, ws, heads, d, mask, layout in k1_cases():
        for dtype in (torch.bfloat16, torch.float32):
            args, kw = k1_case(gen, B, H, ws, heads, d, dtype, layout, mask)
            with torch.inference_mode():
                out = wa.fused_window_attention(*args, **kw)
                torch.cuda.synchronize()
                ref = wa.window_attention_ref(*args, **kw)
            err = (out.float() - ref.float()).abs().max().item()
            lim = bound(dtype, ref.float())
            differ = (out != ref).float().mean().item()
            print(f"k1 {name} {layout}{' +mask' if mask else ''} "
                  f"B={B} {H}x{H} ws={ws} heads={heads} d={d} "
                  f"{str(dtype).split('.')[-1]}: max_abs_err={err:.3e} bound={lim:.3e} "
                  f"(elements differing: {differ:.2e})")
            check(err <= lim, f"K1 {name} {dtype} err {err} > {lim}")
            if dtype == torch.bfloat16 and timed(name):
                worst_bf16 = max(worst_bf16, err)
                (q, k, v, am), _ = sdpa_windows(args[0], args[1], None, kw, args[2])
                with torch.inference_mode():
                    def kern():
                        return wa.fused_window_attention(*args, **kw)

                    def lib():
                        return F.scaled_dot_product_attention(q, k, v, attn_mask=am)
                    k_ms, l_ms = interleaved_graph_ms(kern, lib)
                    t = dict(ms=k_ms, host_ms=cuda_ms(kern),
                             plain_ms=cuda_ms(lambda: wa.window_attention_ref(*args, **kw)),
                             library_ms=l_ms, library_host_ms=cuda_ms(lib))
                t["bound_ms"], t["bound_by"] = bound_ms(B, H, ws, heads, d, dtype,
                                                        backward=False, masked=mask)
                times[name] = t
                print(f"k1 time {name} bf16 B={B}: kernel {t['ms']:.4f} ms (device, CUDA graph; "
                      f"{t['host_ms']:.4f} ms by CUDA events), plain {t['plain_ms']:.4f} ms, "
                      f"library (SDPA fwd on windows) {t['library_ms']:.4f} ms "
                      f"({t['library_host_ms']:.4f}), bound {t['bound_ms']:.4f} ms "
                      f"({t['bound_by']}) [{card_info()}]")
    print_per_pass("k1", "forward", times)
    print_per_pass("k1", "forward", times, S3T_SHAPES, "S3-Tiny bf16 bs128")
    print_per_pass("k1", "forward", times, SWINB_SHAPES, "Swin-B bf16 bs256")
    return worst_bf16, times


def print_per_pass(tag: str, what: str, times: dict, shapes=TINYVIT_SHAPES,
                   model: str = "TinyViT-21M-224 bf16 bs256") -> None:
    """The K1 (K2) times of one forward (train step) of `model`: each
    stage's time times its blocks, and their sum."""
    parts = ", ".join(f"{n} {times[n]['ms']:.4f} x {blocks}"
                      for n, *_, blocks in shapes)
    sums = {k: summed_over_blocks(times, k, shapes) for k in (
        "ms", "host_ms", "plain_ms", "library_ms", "library_host_ms", "bound_ms")}
    print(f"{tag} per {model} {what}: kernel {sums['ms']:.4f} ms "
          f"({parts}; {sums['host_ms']:.4f} by CUDA events), plain {sums['plain_ms']:.4f}, "
          f"library {sums['library_ms']:.4f} ({sums['library_host_ms']:.4f} by CUDA events), "
          f"bound {sums['bound_ms']:.4f} ms [{card_info()}]")


def bwd_bound(dtype, ref: torch.Tensor) -> float:
    """dqkv max-abs bound of K2 vs plain: bf16, two ulps at the largest
    |dqkv| (both round the same fp32 sums, taken in other orders); fp32,
    1e-5 of the largest |dqkv|."""
    top = ref.abs().max().item()
    if dtype == torch.bfloat16:
        return 2.0 ** (np.floor(np.log2(top)) - 6)
    return 1e-5 * top


def phase_k2(gen) -> tuple[float, dict]:
    """K2 against its plain version; dbias bits on two launches; times."""
    worst_bf16, times = 0.0, {}
    for name, B, H, ws, heads, d, mask, layout in k1_cases():
        for dtype in (torch.bfloat16, torch.float32):
            args, kw = k1_case(gen, B, H, ws, heads, d, dtype, layout, mask)
            dout = torch.randn(B, H, H, heads * d, generator=gen, device="cuda").to(dtype)
            dqkv, dbias, dqb = wa.fused_window_attention_bwd(*args, dout, **kw)
            dqkv2, dbias2, _ = wa.fused_window_attention_bwd(*args, dout, **kw)
            torch.cuda.synchronize()
            ref = wa.window_attention_bwd_ref(*args, dout, **kw)
            err = (dqkv.float() - ref[0].float()).abs().max().item()
            lim = bwd_bound(dtype, ref[0].float())
            db_err = (dbias - ref[1]).abs().max().item()
            db_lim = 1e-4 * ref[1].abs().max().item()
            qb_err = (dqb.float() - ref[2].float()).abs().max().item()
            # the token sum of dqkv elements that may differ by an ulp
            qb_lim = (2 ** -6 if dtype == torch.bfloat16 else 1e-4) * \
                ref[2].float().abs().max().item()
            same = torch.equal(dbias, dbias2) and torch.equal(dqkv, dqkv2)
            print(f"k2 {name} {layout}{' +mask' if mask else ''} B={B} {H}x{H} "
                  f"ws={ws} heads={heads} d={d} {str(dtype).split('.')[-1]}: "
                  f"dqkv max_abs_err={err:.3e} bound={lim:.3e}; dbias "
                  f"max_abs_err={db_err:.3e} bound={db_lim:.3e}; d(qkv_bias) "
                  f"max_abs_err={qb_err:.3e} bound={qb_lim:.3e}; "
                  f"two launches bit-identical: {same}")
            check(err <= lim, f"K2 {name} {dtype} dqkv err {err} > {lim}")
            check(db_err <= db_lim, f"K2 {name} {dtype} dbias err {db_err} > {db_lim}")
            check(qb_err <= qb_lim, f"K2 {name} {dtype} d(qkv_bias) err {qb_err} > {qb_lim}")
            check(same, f"K2 {name} {dtype}: two launches differ")
            if dtype == torch.bfloat16 and timed(name, backward=True):
                worst_bf16 = max(worst_bf16, err)
                times[name] = k2_times(args, kw, dout, B, H, ws, heads, d, dtype)
                t = times[name]
                print(f"k2 time {name} bf16 B={B}: kernel {t['ms']:.4f} ms (device, CUDA graph; "
                      f"{t['host_ms']:.4f} ms by CUDA events), plain {t['plain_ms']:.4f} ms, "
                      f"library (SDPA backward on windows) {t['library_ms']:.4f} ms "
                      f"({t['library_how']}; {t['library_host_ms']:.4f} by CUDA events), bound "
                      f"{t['bound_ms']:.4f} ms ({t['bound_by']}); fwd+bwd: K1+K2 "
                      f"autograd.Function {t['pair_ms']:.4f} ms, SDPA "
                      f"{t['library_pair_ms']:.4f} ms (CUDA events) [{card_info()}]")
    print_per_pass("k2", "train step", times)
    print_per_pass("k2", "train step", times, S3T_SHAPES, "S3-Tiny bf16 bs128")
    return worst_bf16, times


def k2_times(args, kw, dout, B, H, ws, heads, d, dtype) -> dict:
    qkv, bias, mask = args

    def kern():
        return wa.fused_window_attention_bwd(qkv, bias, mask, dout, **kw)
    kw_leaf = {k: v for k, v in kw.items() if k != "qkv_bias"}
    leaves = [t.clone().requires_grad_() for t in (qkv, bias, kw["qkv_bias"])]

    def pair():
        out = wa.fused_window_attention(leaves[0], leaves[1], mask, qkv_bias=leaves[2],
                                        **kw_leaf)
        torch.autograd.grad(out, leaves, dout)

    ops, do = sdpa_windows(qkv, bias, dout, kw, mask)
    out = F.scaled_dot_product_attention(*ops[:3], attn_mask=ops[3])

    def lib_fwd():
        return F.scaled_dot_product_attention(*ops[:3], attn_mask=ops[3])

    def lib_bwd():
        return torch.autograd.grad(out, ops, do, retain_graph=True)

    def lib_pair():
        torch.autograd.grad(lib_fwd(), ops, do)

    # autograd runs a backward on its forward's stream, so a CUDA graph
    # holds SDPA's backward only with its forward: the backward's device
    # time is the forward+backward graph's less the forward graph's
    if capturable(lib_pair):
        k_ms, pair_ms, fwd_ms = interleaved_graph_ms(kern, lib_pair, lib_fwd)
        lib_ms, how = pair_ms - fwd_ms, "CUDA graph of fwd+bwd less fwd"
    else:
        (k_ms,) = interleaved_graph_ms(kern)
        lib_ms, how = cuda_ms(lib_bwd), "CUDA events: SDPA's backward was not captured"
    b_ms, by = bound_ms(B, H, ws, heads, d, dtype, backward=True, masked=mask is not None)
    return dict(ms=k_ms, host_ms=cuda_ms(kern),
                plain_ms=cuda_ms(lambda: wa.window_attention_bwd_ref(qkv, bias, mask, dout, **kw)),
                library_ms=lib_ms, library_how=how, library_host_ms=cuda_ms(lib_bwd),
                bound_ms=b_ms, bound_by=by, pair_ms=cuda_ms(pair),
                library_pair_ms=cuda_ms(lib_pair))


def phase_grads(gen) -> None:
    """fp32 at a small shape: the K1+K2 autograd.Function's grads against
    autograd of the plain forward (P's rounding to fp32 is the identity)."""
    for layout, mask in (("head_major", False), ("qkv_major", True)):
        args, kw = k1_case(gen, 2, 14, 7, 3, 32, torch.float32, layout, mask)
        qkv, bias, m = args
        kw.pop("qkv_bias")
        qb = torch.randn(qkv.shape[-1], generator=gen, device="cuda") * 0.1
        leaves = [t.clone().requires_grad_() for t in (qkv, bias, qb)]
        out = wa.fused_window_attention(leaves[0], leaves[1], m, qkv_bias=leaves[2], **kw)
        dout = torch.randn(out.shape, generator=gen, device="cuda")
        got = torch.autograd.grad(out, leaves, dout)
        plain = [t.clone().requires_grad_() for t in (qkv, bias, qb)]
        ref = wa.window_attention_ref(plain[0], plain[1], m, qkv_bias=plain[2], **kw)
        want = torch.autograd.grad(ref, plain, dout)
        errs = [((g - w).abs().max() / w.abs().max()).item() for g, w in zip(got, want)]
        print(f"grads {layout}{' +mask' if mask else ''} fp32 autograd.Function vs "
              f"autograd of the plain forward: max_abs_err / max |grad| for "
              f"qkv, bias, qkv_bias = {', '.join(f'{e:.2e}' for e in errs)} (bound 1e-5)")
        check(max(errs) <= 1e-5, f"autograd.Function grads {layout}: {errs}")


def phase_golden(name: str = "tiny_vit_21m_224", path: Path = GOLDEN) -> None:
    """fp32 logits (B=2) of `name` on seeded weights against the JAX
    package's stored in `path` (K1 on the attention where the model has a
    kernel path)."""
    g = np.load(path)
    x = np.random.default_rng(int(g["input_seed"])).standard_normal(
        (2, 224, 224, 3)).astype(np.float32)
    m = create_model(name, device="cuda", dtype=torch.float32)
    m.load_state_dict(seeded_state_dict(m, int(g["weight_seed"])))
    before = wa.LAUNCHES
    logits = predict(m, torch.from_numpy(x)).cpu().numpy()
    err = float(np.abs(logits - g["logits"]).max())
    # fp32 with TF32 off; cuDNN/cuBLAS/K1 sum in other orders than the
    # CPU reference (the port matches it to ~3e-6 on the CPU)
    lim = 1e-3
    print(f"golden {name} fp32 B=2 vs JAX logits ({wa.LAUNCHES - before} K1 launches): "
          f"max_abs_err={err:.3e} bound={lim:.1e}")
    check(logits.shape == (2, 1000) and bool(np.isfinite(logits).all()), "golden logits")
    check(err <= lim, f"golden {name} err {err} > {lim}")


def phase_train_golden(name: str = "tiny_vit_21m_224", path: Path = TRAIN_GOLDEN) -> None:
    """One fp32 train step of `name` at B=2 (drop path 0, TF32 off; K1 and
    K2 where the model has a kernel path) against the JAX package's, stored
    by tests/test_torch_train.py (TinyViT) or tests/test_torch_swin.py
    (S3-Tiny)."""
    g = np.load(path)
    rng = np.random.default_rng(int(g["input_seed"]))
    x = rng.standard_normal((2, 224, 224, 3)).astype(np.float32)
    y = np.eye(1000, dtype=np.float32)[rng.integers(0, 1000, 2)]
    m = create_model(name, device="cuda", dtype=torch.float32, drop_path_rate=0.0)
    m.load_state_dict(seeded_state_dict(m, int(g["weight_seed"])))
    loss, _, grads = loss_and_grads(m, {"image": torch.from_numpy(x).cuda(),
                                        "label": torch.from_numpy(y).cuda()},
                                    soft_target_ce)
    check_step_golden(f"train golden {name}", g, loss, grads)


def check_step_golden(tag: str, g, loss, grads: dict) -> None:
    """A step's loss and raw grads against a JAX golden's loss, global grad
    norm and per-tensor grad norms: 1e-4, 1e-4 and 1e-3 relative."""
    loss_err = abs(float(loss) - float(g["loss"])) / float(g["loss"])
    gn_err = abs(float(global_norm(grads.values())) - float(g["grad_norm"])) / float(g["grad_norm"])
    check(sorted(grads) == list(g["names"]), "train golden: param names differ")
    got = np.asarray([grads[n].norm().item() for n in g["names"]])
    # per tensor rel 1e-3; grads that are zero up to float noise (TinyViT:
    # the last fc2 bias of stages 1 and 2, before PatchMerging's train-mode
    # BN) at 1e-7 of the norm
    floor = 1e-7 * float(g["grad_norm"])
    diff = np.abs(got - g["grad_norms"])
    excess = diff - (1e-3 * g["grad_norms"] + floor)
    above = g["grad_norms"] > 100 * floor
    worst = float((diff[above] / g["grad_norms"][above]).max())
    print(f"{tag} fp32 B=2 vs JAX: loss rel err {loss_err:.2e} "
          f"(bound 1e-4), grad_norm rel err {gn_err:.2e} (bound 1e-4), per-tensor grad "
          f"norms worst rel err {worst:.2e} over the {int(above.sum())} tensors above "
          f"100x the noise floor (bound 1e-3); the {int((~above).sum())} at float noise "
          f"within {float(diff[~above].max(initial=0.0)):.1e} (floor {floor:.1e})")
    check(loss_err <= 1e-4, f"{tag} loss rel err {loss_err}")
    check(gn_err <= 1e-4, f"{tag} grad_norm rel err {gn_err}")
    check(bool((excess <= 0).all()), f"{tag} per-tensor grad norms")


def smooth_images(gen, batch: int, size: int = 224, grid: int = 4) -> torch.Tensor:
    """Random low-frequency images (NHWC, unit std): a grid x grid field of
    normal noise per channel, bicubic-upsampled. With seeded weights, logits
    on white noise barely depend on the image (their fp32 top-2 margin is
    below bf16 resolution for ~10% of images); on these they do."""
    low = torch.randn(batch, 3, grid, grid, generator=gen, device="cuda")
    x = F.interpolate(low, size=size, mode="bicubic", align_corners=False)
    x = x.permute(0, 2, 3, 1)
    return (x / x.std()).contiguous()


def set_kernel(model: torch.nn.Module, on: bool) -> None:
    """The window attention's kernel route (K1/K2) on or off."""
    for mod in model.modules():
        if isinstance(mod, (WindowBiasAttention, SwinWindowAttention)):
            mod.use_kernel = on


def kernel_rounds(rounds: int) -> list[bool]:
    """The routes of `rounds` interleaved rounds after a first kernel run:
    kernel (the first, already run), plain, plain, kernel, kernel, plain,
    ... (True: kernel)."""
    return [i % 4 in (0, 3) for i in range(1, 2 * rounds)]


def phase_main(name: str = "tiny_vit_21m_224", batch: int = BATCH, per: int = 10,
               rounds: int = 2, lim_ulps: float | None = None,
               top1_on_decided: bool = False) -> int:
    """An eval main path (bf16) through predict and throughput: `per` K1
    launches a forward; the kernel route against the plain one on the same
    weights (top-1 on all images, or with `top1_on_decided` on those whose
    top-2 margin is above 4 bf16 ulps, as for EfficientViT; logits within
    5e-2, or `lim_ulps` bf16 ulps at the largest |logit|); img/s of both in
    `rounds` interleaved rounds. Returns the K1 launches of its first
    predict + throughput."""
    dtype = torch.bfloat16
    gen = torch.Generator("cuda").manual_seed(0)
    model = create_model(name, device="cuda", dtype=dtype)
    model.load_state_dict(seeded_state_dict(model, 0))
    size = model.img_size
    n_attn = sum(isinstance(m, (WindowBiasAttention, SwinWindowAttention))
                 for m in model.modules())
    x = smooth_images(gen, batch, size).to(dtype)
    noise = torch.randn(batch, size, size, 3, generator=gen, device="cuda").to(dtype)
    # top-1 agreement over at least 256 images: one flip at a near-tie is
    # then under 0.4%
    more = [smooth_images(gen, batch, size).to(dtype) for _ in range(256 // batch - 1)]
    warmup, iters = 3, 20

    wa.LAUNCHES = wa.BWD_LAUNCHES = 0
    logits = predict(model, x)
    per_forward = wa.LAUNCHES
    ips = {True: [throughput(model, batch, size, dtype, iters, warmup)], False: []}
    launches = wa.LAUNCHES
    check(per_forward == n_attn == per, f"{per_forward} K1 launches per forward, want {per}")
    check(launches == per_forward * (1 + warmup + iters),
          f"{launches} K1 launches in the main path, want {per_forward * (1 + warmup + iters)}")
    check(wa.BWD_LAUNCHES == 0, "eval launched K2")
    check(logits.shape == (batch, 1000) and bool(torch.isfinite(logits).all()),
          "main-path logits not finite")

    noise_k1 = predict(model, noise)
    logits = torch.cat([logits] + [predict(model, m) for m in more])
    set_kernel(model, False)
    plain = torch.cat([predict(model, m) for m in [x] + more])
    noise_plain = predict(model, noise)
    for on in kernel_rounds(rounds):
        set_kernel(model, on)
        ips[on].append(throughput(model, batch, size, dtype, iters, warmup))
    # the white-noise and further smooth forwards, then the kernel route's
    # further rounds
    check(wa.LAUNCHES == launches + per * (1 + len(more) + (warmup + iters) * (rounds - 1)),
          "plain path launched K1 or kernel path did not")
    agree, decided, agree_decided = top1_agreement(logits, plain)
    err = (logits - plain).abs().max().item()
    # both paths bf16 with the same rounding points; they differ only where
    # K1's fp32 sums, taken in another order, round P or out to another bf16
    lim = 5e-2 if lim_ulps is None else lim_ulps * bf16_ulp(plain.abs().max()).item()
    card = card_info()
    n_decided = round(decided * len(plain))
    print(f"main {name} bf16 B={batch}: K1 launches/forward={per_forward}, "
          f"top-1 agreement kernel vs plain={agree:.4f} over {len(plain)} images"
          f"{'' if top1_on_decided else ' (need >= 0.99)'}, {agree_decided:.4f} on the "
          f"{n_decided} whose top-2 margin is above 4 bf16 ulps"
          f"{' (need >= 0.99 on >= 100)' if top1_on_decided else ''}, "
          f"logits max_abs_err={err:.3e} bound={lim:.1e}")
    noise_agree = (noise_k1.argmax(-1) == noise_plain.argmax(-1)).float().mean().item()
    print(f"main white-noise images (not checked; top-2 margins below bf16 "
          f"resolution): top-1 agreement kernel vs plain={noise_agree:.4f}")
    print(f"main throughput {name} bf16 B={batch}: kernel path "
          f"{' / '.join(f'{v:.1f}' for v in ips[True])} img/s, plain attention "
          f"{' / '.join(f'{v:.1f}' for v in ips[False])} img/s [{card}]")
    if top1_on_decided:
        check(n_decided >= 100 and agree_decided >= 0.99,
              f"top-1 agreement {agree_decided} on {n_decided} decided images")
    else:
        check(agree >= 0.99, f"top-1 agreement {agree} < 0.99")
    check(err <= lim, f"kernel vs plain logits err {err} > {lim}")
    return launches


def phase_train(name: str = "tiny_vit_21m_224", batch: int = BATCH,
                per: int = 10) -> tuple[int, int]:
    """A train main path: `name` bf16, AdamW as the trainer builds it, the
    variant's drop path; `per` K1 + `per` K2 launches a step. Returns its
    K1 and K2 launches."""
    dtype = torch.bfloat16
    gen = torch.Generator("cuda").manual_seed(1)
    model = create_model(name, device="cuda", dtype=dtype)
    model.load_state_dict(seeded_state_dict(model, 0))
    size = model.img_size
    plain = copy.deepcopy(model)
    set_kernel(plain, False)
    x = smooth_images(gen, batch, size).to(dtype)
    labels = torch.randint(0, 1000, (batch,), generator=gen, device="cuda")
    batch_d = {"image": x, "label": F.one_hot(labels, 1000).float()}

    def new_state(m):
        return TrainState(m, make_adamw(1e-3, weight_decay=0.05, clip_grad=5.0,
                                        params=dict(m.named_parameters())))

    step = make_train_step(loss_fn=soft_target_ce)
    state, n_steps, warmup, iters = new_state(model), 10, 3, 10
    torch.cuda.reset_peak_memory_stats()
    wa.LAUNCHES = wa.BWD_LAUNCHES = 0
    losses, first = [], None
    for i in range(n_steps):
        state, metrics = step(state, batch_d, 0)
        first = first or metrics
        losses.append(float(metrics["loss"]))
        if i == 0:
            per_step = (wa.LAUNCHES, wa.BWD_LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ips_k = train_throughput(model, batch, size, dtype, iters, warmup)
    launches = (wa.LAUNCHES, wa.BWD_LAUNCHES)
    want = per * (n_steps + warmup + iters)
    check(per_step == (per, per), f"{per_step} K1/K2 launches per train step, want {per} each")
    check(launches == (want, want), f"{launches} K1/K2 launches in the train path, want {want}")

    torch.cuda.reset_peak_memory_stats()
    pstate = new_state(plain)
    _, pmetrics = step(pstate, batch_d, 0)
    peak_plain = torch.cuda.max_memory_allocated() / 2 ** 30
    ips_p = train_throughput(plain, batch, size, dtype, iters, warmup)
    ips_p2 = train_throughput(plain, batch, size, dtype, iters, warmup)
    ips_k2 = train_throughput(model, batch, size, dtype, iters, warmup)
    check(wa.LAUNCHES == launches[0] + per * (warmup + iters) and
          wa.BWD_LAUNCHES == launches[1] + per * (warmup + iters),
          "the plain path launched K1/K2 or the kernel path did not")

    l_k, l_p = float(first["loss"]), float(pmetrics["loss"])
    g_k, g_p = float(first["grad_norm"]), float(pmetrics["grad_norm"])
    # bf16 logits and log-softmax: the loss terms sit on a bf16 grid, so the
    # paths may differ by rounding steps there (2 ulps at the loss); the
    # grads flow through bf16 activations rounded at other points, 2%
    loss_lim = 2 * 2.0 ** (np.floor(np.log2(l_p)) - 7)
    card = card_info()
    print(f"train {name} bf16 B={batch}: K1/K2 launches per step="
          f"{per_step[0]}/{per_step[1]}, loss over {n_steps} steps on one batch: "
          f"{', '.join(f'{v:.4f}' for v in losses)}")
    print(f"train step 1 kernel vs plain path: loss {l_k:.5f} vs {l_p:.5f} "
          f"(|diff| {abs(l_k - l_p):.2e}, bound {loss_lim:.2e}); grad_norm {g_k:.4f} "
          f"vs {g_p:.4f} (rel diff {abs(g_k - g_p) / g_p:.2e}, bound 2e-2)")
    print(f"train throughput {name} bf16 B={batch}: kernel path {ips_k:.1f} / {ips_k2:.1f} "
          f"img/s, plain attention {ips_p:.1f} / {ips_p2:.1f} img/s; peak memory "
          f"{peak:.2f} GiB (kernel path), {peak_plain:.2f} GiB (plain) [{card}]")
    check(all(np.isfinite(losses)), "train loss not finite")
    check(losses[-1] < losses[0], f"train loss did not fall: {losses}")
    check(abs(l_k - l_p) <= loss_lim, f"kernel vs plain loss {l_k} vs {l_p}")
    check(abs(g_k - g_p) <= 2e-2 * g_p, f"kernel vs plain grad_norm {g_k} vs {g_p}")
    return launches


def distill_mapping(path: Path, missing: int = 5, seed: int = 0) -> np.ndarray:
    """A seeded 1k -> 22k mapping file (1000 distinct 22k classes, `missing`
    of them -1: absent from the 22k head), as imagenet_1kto22k.txt lays it
    out. The real file is not in the repository."""
    rng = np.random.default_rng(seed)
    mapping = rng.choice(21841, 1000, replace=False)
    mapping[rng.choice(1000, missing, replace=False)] = -1
    np.savetxt(path, mapping, fmt="%d")
    return mapping


def distill_batch(store: Path, dtype) -> dict:
    """The first batch of epoch 0 as the distill trainer builds it
    (`cli.train.distill_batch`) from the store, on the card."""
    from cream_tpu_torch.cli import train as train_cli
    from cream_tpu_torch.core.config import Config
    from cream_tpu_torch.data.imagenet import train_loader
    from cream_tpu_torch.distill import LogitsReader
    cfg = Config.from_yaml(None, ["data.dataset=synthetic", f"data.batch_size={BATCH}"])
    batch = next(iter(train_loader(train_cli.build_dataset(cfg), BATCH, 0, 0, 8)))
    reader = LogitsReader(str(store), 0)
    out = train_cli.distill_batch(cfg, batch, reader, "cuda", dtype)
    reader.close()
    return out


def phase_distill() -> tuple[int, int]:
    """TinyViT's fast pretraining distillation through the CLIs' main(argv)
    in this process, into a temporary directory: save_logits with a seeded
    Swin-B-22k teacher (bf16 bs256, the 22k -> 1k remap of a seeded mapping
    with 5 absent classes, top-100), its --check pass, and the distill
    train CLI on TinyViT-21M-224 (bf16 bs256, mixup 0.8 / cutmix 1.0); a
    store without its recipe refused; then the distill step alone: its
    launches, img/s and peak memory, the fp32 B=2 step against the JAX
    golden, and the bf16 step against the plain attention route. Returns the
    K1 and K2 launches of the main path (the three CLI runs and the timed
    steps)."""
    import shutil
    import tempfile

    from cream_tpu_torch.cli import save_logits
    from cream_tpu_torch.cli import train as train_cli
    from cream_tpu_torch.data.det_aug import sample_seed
    from cream_tpu_torch.distill import LogitsReader, native

    card = card_info()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        tmp = Path(tmp)
        store = tmp / "store"
        mapping = distill_mapping(tmp / "map.txt")
        teacher = ["model.name=swin_base", "model.num_classes=21841", "model.dtype=bfloat16",
                   "data.dataset=synthetic", f"data.batch_size={SWINB_BATCH}",
                   "distill.logits_topk=100", "--allow-random", "--remap-1kto22k",
                   str(tmp / "map.txt"), "--out", str(store)]
        wa.LAUNCHES = wa.BWD_LAUNCHES = 0
        (saved,) = save_logits.main(teacher)
        forwards = len(saved["ms"]["teacher"])
        per_forward = wa.LAUNCHES / forwards
        check(wa.LAUNCHES == 24 * forwards and wa.BWD_LAUNCHES == 0,
              f"save_logits: {wa.LAUNCHES} K1 / {wa.BWD_LAUNCHES} K2 launches in "
              f"{forwards} Swin-B forwards, want 24 a forward and no K2")
        check(saved["native"] and native.library_path().exists(),
              "save_logits did not write through the native codec")
        reader = LogitsReader(str(store), 0)
        n = reader.num_samples
        vals, idxs, seeds = reader.read_batch(np.arange(n))
        reader.close()
        check(saved["records"] == n == 4 * SWINB_BATCH, f"{saved['records']} records of {n}")
        check(np.array_equal(seeds, [sample_seed(0, 0, i) for i in range(n)]),
              "stored seeds are not sample_seed(0, 0, index)")
        absent = np.flatnonzero(mapping < 0)
        check(bool((vals.sum(-1) < 1).all()), "a record's top-100 sums to 1 or more")
        check(not np.isin(idxs, absent).any(), "an absent 22k class was stored")
        med = {k: statistics.median(v[1:]) for k, v in saved["ms"].items()}
        print(f"distill save_logits swin_base-22k bf16 B={SWINB_BATCH}: {forwards} forwards, "
              f"K1 launches/forward={per_forward:.0f}, {n} records, native codec "
              f"{native.library_path().name}; per batch (median of batches 2-{forwards}): "
              f"teacher {med['teacher']:.3f} ms = "
              f"{SWINB_BATCH / med['teacher'] * 1e3:.1f} img/s (mixup, forward, remap, "
              f"softmax), host ms: upload {med['upload']:.3f}, top-K {med['topk']:.3f}, "
              f"transfer {med['transfer']:.3f}, pack_write {med['pack_write']:.3f}; "
              f"whole pass {saved['wall_ms'] / 1e3:.2f} s; top-100 mass "
              f"{vals.sum(-1).min():.4f}-{vals.sum(-1).max():.4f}, top-1 "
              f"{vals[:, 0].min():.4f}-{vals[:, 0].max():.4f} [{card}]")
        (checked,) = save_logits.main(teacher + ["--check"])
        check(wa.LAUNCHES == 48 * forwards, "the --check pass did not run K1 24 a forward")
        print(f"distill save_logits --check: value max err {checked['value_max_err']:.3e} "
              f"(bound 1e-3: the fp16 store), index diff rate "
              f"{checked['index_diff_rate']:.4f} (JAX's metric, counts tie order), tie-aware "
              f"miss rate {checked['index_miss_rate']:.4f} (bound 0) over {checked['n']}")
        check(checked["value_max_err"] <= 1e-3, f"--check value error {checked['value_max_err']}")
        check(checked["index_miss_rate"] == 0.0, f"--check miss rate {checked['index_miss_rate']}")

        student = ["model.name=tiny_vit_21m_224", "model.dtype=bfloat16",
                   "data.dataset=synthetic", f"data.batch_size={BATCH}", "distill.enabled=true",
                   f"distill.teacher_logits_path={store}", "aug.mixup=0.8", "aug.cutmix=1.0",
                   "train.epochs=1", "train.warmup_epochs=0", "train.nan_budget=0",
                   f"output={tmp / 'out'}"]
        k1, k2 = wa.LAUNCHES, wa.BWD_LAUNCHES
        train_cli.main(student)
        steps = eval_forwards = n // BATCH
        check((wa.LAUNCHES - k1, wa.BWD_LAUNCHES - k2) ==
              (10 * (steps + eval_forwards), 10 * steps),
              f"distill train: {wa.LAUNCHES - k1} K1 / {wa.BWD_LAUNCHES - k2} K2 launches, "
              f"want 10 + 10 a step over {steps} steps and 10 K1 a forward over "
              f"{eval_forwards} eval forwards")
        print(f"distill train CLI tiny_vit_21m_224 bf16 B={BATCH}: {steps} steps, "
              f"{wa.LAUNCHES - k1} K1 / {wa.BWD_LAUNCHES - k2} K2 launches (10 + 10 a step, "
              f"10 K1 a forward of the eval pass), stored seeds equal the loader's, loss "
              f"finite (train.nan_budget=0)")
        bare = tmp / "bare"
        shutil.copytree(store, bare)
        (bare / "recipe.json").unlink()
        try:
            train_cli.main([*student[:5], f"distill.teacher_logits_path={bare}", *student[6:]])
            check(False, "a store without recipe.json was replayed")
        except ValueError as e:
            print(f"distill train refuses a store without recipe.json: {str(e)[:100]}...")
        launches = (wa.LAUNCHES, wa.BWD_LAUNCHES)
        batch = distill_batch(store, torch.bfloat16)
        distill_host_times(store, tmp / "map.txt")
    stepped = distill_step_times(batch)
    launches = (launches[0] + stepped[0], launches[1] + stepped[1])
    phase_distill_golden()
    phase_distill_routes(batch)
    return launches


def distill_host_times(store: Path, map_path: Path) -> None:
    """Where a batch's time goes outside the models' kernels, on one bs256
    batch, each the median of 5 (host clock around work that ends in a
    synchronize, or CUDA events): the synthetic loader's batch (8 threads),
    the seeded pair mixup (its host draws and the device mix), Swin-B-22k's
    forward, the remap + softmax + top-K, the store's read of a batch
    (native codec) and the student's mixup replay on bf16 images. Not the
    main path: its K1 launches are not counted."""
    from cream_tpu_torch.cli.train import build_dataset
    from cream_tpu_torch.core.config import Config
    from cream_tpu_torch.data.imagenet import train_loader
    from cream_tpu_torch.data.mixup import seeded_pair_mixup
    from cream_tpu_torch.distill import LogitsReader
    from cream_tpu_torch.zoo.remap import load_1k_to_22k, remap_22k_to_1k

    def host_ms(fn, reps: int = 5) -> float:
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    cfg = Config.from_yaml(None, ["data.dataset=synthetic", f"data.batch_size={SWINB_BATCH}"])
    ds = build_dataset(cfg)
    it = iter(train_loader(ds, SWINB_BATCH, 0, 0, 8))
    t0 = time.perf_counter()
    batches = list(it)
    loader_ms = (time.perf_counter() - t0) * 1e3 / len(batches)
    batch = batches[0]
    x = torch.from_numpy(batch["image"]).cuda()
    seeds, zeros = batch["seed"], torch.zeros(SWINB_BATCH, dtype=torch.int64, device="cuda")
    a = cfg.aug
    mix = host_ms(lambda: seeded_pair_mixup(seeds, x, zeros, 1, a.mixup, a.cutmix,
                                            a.mixup_switch_prob))
    teacher = create_model("swin_base", num_classes=21841, device="cuda", dtype=torch.bfloat16)
    teacher.load_state_dict(seeded_state_dict(teacher, 0))
    mapping = torch.from_numpy(load_1k_to_22k(str(map_path))).cuda()
    x16 = x.to(torch.bfloat16)
    with torch.inference_mode():
        logits = teacher(x16)
        fwd = cuda_ms(lambda: teacher(x16), iters=2, reps=5)
        head = cuda_ms(lambda: torch.softmax(remap_22k_to_1k(logits, mapping).float(), -1)
                       .topk(100, dim=-1))
    del teacher, logits
    reader = LogitsReader(str(store), 0)
    read = host_ms(lambda: reader.read_batch(batch["index"]))
    reader.close()
    replay = host_ms(lambda: seeded_pair_mixup(seeds, x16, zeros, 1, a.mixup, a.cutmix,
                                               a.mixup_switch_prob)[0].to(torch.bfloat16))
    print(f"distill host/device times a bs{SWINB_BATCH} batch (median of 5): synthetic loader "
          f"{loader_ms:.1f} ms (host, 8 threads, mean of {len(batches)} batches), seeded pair "
          f"mixup {mix:.2f} ms (host draws + device mix), Swin-B-22k forward {fwd:.2f} ms "
          f"(CUDA events), remap + softmax + top-K {head:.3f} ms, store read {read:.2f} ms "
          f"(host, native), student mixup replay {replay:.2f} ms [{card_info()}]")


def distill_step_times(batch: dict) -> tuple[int, int]:
    """The bf16 bs256 distill step of TinyViT-21M-224 (AdamW as the trainer
    builds it, drop path 0.2) on a store batch: 10 K1 + 10 K2 launches a
    step, finite losses, teacher agreement, img/s by CUDA events over 10
    steps after 3, peak memory. Returns its K1 and K2 launches."""
    from cream_tpu_torch.distill.pipeline import make_distill_train_step
    model = create_model("tiny_vit_21m_224", device="cuda", dtype=torch.bfloat16)
    model.load_state_dict(seeded_state_dict(model, 0))
    state = TrainState(model, make_adamw(1e-3, weight_decay=0.05, clip_grad=5.0,
                                         params=dict(model.named_parameters())))
    step = make_distill_train_step(1000)
    torch.cuda.reset_peak_memory_stats()
    k1, k2 = wa.LAUNCHES, wa.BWD_LAUNCHES
    state, metrics = step(state, batch)
    per_step = (wa.LAUNCHES - k1, wa.BWD_LAUNCHES - k2)
    losses, agree = [float(metrics["loss"])], [float(metrics["teacher_agree"])]
    for _ in range(2):
        state, metrics = step(state, batch)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(10):
        state, metrics = step(state, batch)
        losses.append(metrics["loss"])
        agree.append(metrics["teacher_agree"])
    end.record()
    end.synchronize()
    ips = 10 * BATCH / (start.elapsed_time(end) / 1e3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses, agree = [float(v) for v in losses], [float(v) for v in agree]
    print(f"distill step tiny_vit_21m_224 bf16 B={BATCH}: K1/K2 launches per step "
          f"{per_step[0]}/{per_step[1]}, loss {losses[0]:.4f} -> {losses[-1]:.4f} over 13 "
          f"steps on one batch, teacher_agree {agree[0]:.4f} -> {agree[-1]:.4f}, "
          f"{ips:.1f} img/s (CUDA events, 10 steps after 3), peak memory {peak:.2f} GiB "
          f"[{card_info()}]")
    check(per_step == (10, 10), f"{per_step} K1/K2 launches per distill step, want 10 each")
    check(all(np.isfinite(losses)), "distill loss not finite")
    return wa.LAUNCHES - k1, wa.BWD_LAUNCHES - k2


def phase_distill_golden() -> None:
    """The fp32 distill step of TinyViT-21M-224 at B=2 (drop path 0, TF32
    off, K1 and K2) against the JAX golden stored by
    tests/test_torch_distill.py: loss, grad norm, per-tensor grad norms."""
    from cream_tpu_torch.distill.pipeline import make_distill_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = np.load(DATA / "tinyvit_21m_224_distill_seed0.npz")
    x = np.random.default_rng(int(g["input_seed"])).standard_normal(
        (2, 224, 224, 3)).astype(np.float32)
    m = create_model("tiny_vit_21m_224", device="cuda", dtype=torch.float32,
                     drop_path_rate=0.0)
    m.load_state_dict(seeded_state_dict(m, int(g["weight_seed"])))
    state = TrainState(m, make_adamw(1e-3))
    grads = {}
    state.apply_gradients = lambda gr: grads.update(gr) or state
    k1, k2 = wa.LAUNCHES, wa.BWD_LAUNCHES
    _, metrics = make_distill_train_step(1000)(state, {
        "image": torch.from_numpy(x).cuda(),
        "topk_values": torch.from_numpy(g["topk_values"]).cuda(),
        "topk_indices": torch.from_numpy(g["topk_indices"]).cuda()})
    check((wa.LAUNCHES - k1, wa.BWD_LAUNCHES - k2) == (10, 10),
          "the fp32 distill step did not launch K1/K2 10 times each")
    check_step_golden("distill golden tiny_vit_21m_224", g, metrics["loss"], grads)


def phase_distill_routes(batch: dict) -> None:
    """The bf16 distill step on K1/K2 against the plain attention route on
    the same weights and batch: loss within 2 ulps, grad_norm within 2%
    (the train phases' bounds)."""
    from cream_tpu_torch.distill.pipeline import make_distill_train_step
    model = create_model("tiny_vit_21m_224", device="cuda", dtype=torch.bfloat16)
    model.load_state_dict(seeded_state_dict(model, 0))
    plain = copy.deepcopy(model)
    set_kernel(plain, False)
    step = make_distill_train_step(1000)
    out = []
    for m in (model, plain):
        k1 = wa.LAUNCHES
        _, metrics = step(TrainState(m, make_adamw(1e-3, weight_decay=0.05, clip_grad=5.0,
                                                   params=dict(m.named_parameters()))), batch)
        out.append((float(metrics["loss"]), float(metrics["grad_norm"]), wa.LAUNCHES - k1))
    (l_k, g_k, n_k), (l_p, g_p, n_p) = out
    loss_lim = 2 * 2.0 ** (np.floor(np.log2(l_p)) - 7)
    print(f"distill step bf16 kernel vs plain route: loss {l_k:.5f} vs {l_p:.5f} (|diff| "
          f"{abs(l_k - l_p):.2e}, bound {loss_lim:.2e}); grad_norm {g_k:.4f} vs {g_p:.4f} "
          f"(rel diff {abs(g_k - g_p) / g_p:.2e}, bound 2e-2); K1 launches {n_k} / {n_p}")
    check((n_k, n_p) == (10, 0), f"K1 launches kernel/plain route {n_k}/{n_p}")
    check(abs(l_k - l_p) <= loss_lim, f"distill kernel vs plain loss {l_k} vs {l_p}")
    check(abs(g_k - g_p) <= 2e-2 * g_p, f"distill kernel vs plain grad_norm {g_k} vs {g_p}")


def phase_mini_swin(batch: int = S3T_BATCH) -> None:
    """Mini-Swin-T bf16 eval through predict and throughput: its head
    transforms take the plain attention route, as in JAX, so no K1."""
    dtype = torch.bfloat16
    model = create_model("mini_swin_tiny", device="cuda", dtype=dtype)
    model.load_state_dict(seeded_state_dict(model, 0))
    x = smooth_images(torch.Generator("cuda").manual_seed(0), batch).to(dtype)
    before = (wa.LAUNCHES, wa.BWD_LAUNCHES)
    logits = predict(model, x)
    ips = throughput(model, batch, 224, dtype, 20, 3)
    print(f"main mini_swin_tiny bf16 B={batch}: K1/K2 launches "
          f"{wa.LAUNCHES - before[0]}/{wa.BWD_LAUNCHES - before[1]} (want 0), "
          f"{ips:.1f} img/s [{card_info()}]")
    check((wa.LAUNCHES, wa.BWD_LAUNCHES) == before, "Mini-Swin launched K1/K2")
    check(logits.shape == (batch, 1000) and bool(torch.isfinite(logits).all()),
          "Mini-Swin logits not finite")


def k5_bound_ms(W: int, N: int, d: int, dtype) -> tuple[float, str]:
    """K5's least time: q, k, v and the bias read once, out written once;
    Q.K^T and P.V."""
    e = torch.finfo(dtype).bits // 8
    nbytes = W * N * (2 * KD + d) * e + N * N * 4 + W * N * d * e
    return roofline_ms(nbytes, W * 2 * N * N * (KD + d), dtype)


def phase_k5(gen) -> tuple[float, dict]:
    """K5 against its plain version at the EfficientViT per-head shapes;
    bf16 times of the kernel, the plain version and SDPA."""
    worst_bf16, times = 0.0, {}
    for model, _ in EVIT_PATHS:
        for name, W, ws, C, heads, _, blocks in EVIT_STAGES[model]:
            N, d = ws * ws, C // heads
            for dtype in (torch.bfloat16, torch.float32):
                q, k = (torch.randn(W, N, KD, generator=gen, device="cuda").to(dtype)
                        for _ in range(2))
                v = torch.randn(W, N, d, generator=gen, device="cuda").to(dtype)
                bias = torch.randn(N, N, generator=gen, device="cuda") * 0.5
                args = (q, k, v, bias, KD ** -0.5)
                with torch.inference_mode():
                    out = cga_core.cga_attention(*args)
                    torch.cuda.synchronize()
                    ref = cga_core.cga_attention_ref(*args)
                err = (out.float() - ref.float()).abs().max().item()
                lim = bound(dtype, ref.float())
                print(f"k5 {name} W={W} N={N} kd={KD} d={d} {str(dtype).split('.')[-1]}: "
                      f"max_abs_err={err:.3e} bound={lim:.3e} (elements differing: "
                      f"{(out != ref).float().mean().item():.2e})")
                check(err <= lim, f"K5 {name} {dtype} err {err} > {lim}")
                if dtype != torch.bfloat16:
                    continue
                with torch.inference_mode():
                    check(torch.equal(cga_core.cga_attention(*args), out),
                          f"K5 {name}: other bits on a second launch")
                worst_bf16 = max(worst_bf16, err)
                lq, lk, lv = (t[:, None] for t in (q, k, v))    # (W, 1, N, .)
                mask = bias.to(dtype)
                t = kernel_plain_library_ms(
                    lambda: cga_core.cga_attention(*args),
                    lambda: cga_core.cga_attention_ref(*args),
                    lambda: F.scaled_dot_product_attention(lq, lk, lv, attn_mask=mask))
                t["bound_ms"], t["bound_by"] = k5_bound_ms(W, N, d, dtype)
                times[name] = dict(t, per_forward=blocks * heads)
                print(f"k5 time {name} bf16 W={W}: {format_times(t)}, library = SDPA on "
                      f"(W, 1, N, d), bias as attn_mask [{card_info()}]")
    for model, batch in EVIT_PATHS:
        tot = {k: sum(times[n][k] * times[n]["per_forward"] for n, *_ in EVIT_STAGES[model])
               for k in ("ms", "host_ms", "plain_ms", "library_ms", "library_host_ms",
                         "bound_ms")}
        print(f"k5 per {model} bf16 bs{batch} forward: kernel {tot['ms']:.4f} ms "
              f"({tot['host_ms']:.4f} by CUDA events), plain {tot['plain_ms']:.4f}, library "
              f"{tot['library_ms']:.4f} ({tot['library_host_ms']:.4f}), bound "
              f"{tot['bound_ms']:.4f} ms")
    return worst_bf16, times


def seeded_cga(C: int, heads: int, ws: int, kernels, dtype, seed: int) -> CascadedGroupAttention:
    m = CascadedGroupAttention(C, KD, heads, C / (KD * heads), ws, kernels,
                               device="cuda", dtype=dtype).eval()
    m.load_state_dict(seeded_state_dict(m, seed))
    return m


def k4_bound_ms(W: int, ws: int, C: int, heads: int, kernels, dtype) -> tuple[float, str]:
    """K4's least time: x read and out written once, the folded weights and
    the bias read once; the qkv and proj products, the depthwise taps that
    fall inside the window (of each head's own kernel), Q.K^T and P.V."""
    e = torch.finfo(dtype).bits // 8
    N, d = ws * ws, C // heads
    L = 2 * KD + d
    ks_max = max(kernels[:heads])
    nbytes = (2 * W * N * C * e + (heads * d * L + C * C) * e
              + (heads * N * N + heads * L + heads * ks_max * ks_max * KD + heads * KD + C) * 4)
    taps = 0
    for ks in kernels[:heads]:
        p = ks // 2
        inside = [sum(0 <= y + t - p < ws for t in range(ks)) for y in range(ws)]
        taps += sum(inside) ** 2
    flops = W * (heads * 2 * N * d * L + 2 * taps * KD + heads * 2 * N * N * (KD + d)
                 + 2 * N * C * C)
    return roofline_ms(nbytes, flops, dtype)


def k4_bound(dtype, ref: torch.Tensor) -> float:
    """Max-abs bound of K4 vs plain: bf16, 8 ulps at the largest |out|, four
    times `bound`'s (an ulp of difference in one head's rounded output feeds
    the next head's qkv and the projection's sum over C channels); fp32 as
    `bound` (fp32 sums in other orders through the cascade)."""
    return bound(dtype, ref) * (4 if dtype == torch.bfloat16 else 1)


def phase_k4(gen) -> tuple[float, dict]:
    """K4 against its plain version on seeded modules' folds at the
    EfficientViT stage shapes, bf16 and fp32; its launch plan against the
    library's; bf16 the same bits on two launches and window counts that
    leave the last block short (1, 3, G + 1); bf16 device times of the
    kernel, the plain version and the unfused "plain"-route module by
    CUDA-graph replay in 3 interleaved rounds (CUDA events beside them),
    per stage and summed per M5 and M0 forward."""
    worst_bf16, times = 0.0, {}
    for model, _ in EVIT_PATHS:
        for name, W, ws, C, heads, kernels, blocks in EVIT_STAGES[model]:
            d = C // heads
            for dtype in (torch.bfloat16, torch.float32):
                m = seeded_cga(C, heads, ws, kernels, dtype, seed=C + ws)
                plan = cga.launch_plan(W, ws, heads, KD, d, m.ks_max, dtype)
                lib = cga.library_plan(W, ws, heads, KD, d, m.ks_max, dtype)
                check(plan == lib, f"K4 {name} {dtype}: plan {plan} != the library's {lib}")
                x = torch.randn(W, ws, ws, C, generator=gen, device="cuda").to(dtype)
                kw = dict(ws=ws, heads=heads, c_in=d, kd=KD, d=d, ks_max=m.ks_max)
                ops = (m.attention_biases, m.attention_bias_idxs, *m.folded())
                with torch.inference_mode():
                    out = cga.fused_cga(x, *ops, **kw)
                    again = cga.fused_cga(x, *ops, **kw)
                    torch.cuda.synchronize()
                    ref = cga.fused_cga_ref(x, *ops, **kw)
                err = (out.float() - ref.float()).abs().max().item()
                lim = k4_bound(dtype, ref.float())
                ulp = bf16_ulp(ref.float().abs().max().clamp_min(1.0)).item()
                same = torch.equal(out, again)
                print(f"k4 {name} W={W} ws={ws} C={C} heads={heads} kernels={kernels} "
                      f"{str(dtype).split('.')[-1]} ({plan.windows} windows a block, "
                      f"{plan.smem} bytes of shared memory): max_abs_err={err:.3e} "
                      f"bound={lim:.3e} ({err / ulp:.2f} bf16 ulps at max |out|; elements "
                      f"differing: {(out != ref).float().mean().item():.2e}); two launches "
                      f"bit-identical: {same}")
                check(err <= lim, f"K4 {name} {dtype} err {err} > {lim}")
                check(out.shape == x.shape and bool(torch.isfinite(out).all()), f"K4 {name} output")
                if dtype != torch.bfloat16:
                    continue
                check(same, f"K4 {name}: other bits on a second launch")
                worst_bf16 = max(worst_bf16, err)
                kw1 = {k: v for k, v in kw.items() if k != "c_in"}
                for nw in (1, 3, plan.windows + 1):
                    xr = x[:nw]
                    with torch.inference_mode():
                        got = cga._launch(xr, *ops, plan.windows, **kw1)
                        torch.cuda.synchronize()
                        want = cga.fused_cga_ref(xr, *ops, **kw)
                    e = (got.float() - want.float()).abs().max().item()
                    check(e <= k4_bound(dtype, want.float()),
                          f"K4 {name}: {nw} windows err {e}")
                    check(torch.equal(got, out[:nw]),
                          f"K4 {name}: {nw} windows differ from the same windows in {W}")
                print(f"k4 {name} bf16 at 1, 3 and {plan.windows + 1} windows, "
                      f"{plan.windows} a block (the last block short): within the bound and "
                      f"bit-identical to the same windows among {W}")

                with torch.inference_mode():
                    def kern():
                        return cga.fused_cga(x, *ops, **kw)

                    def plain():
                        return cga.fused_cga_ref(x, *ops, **kw)

                    def module():
                        return m(x)
                    m.attn_kernel = "plain"
                    n0 = cga.LAUNCHES
                    k_ms, p_ms, u_ms = interleaved_graph_ms(kern, plain, module)
                    check(cga.LAUNCHES > n0, f"K4 {name}: the timing did not launch K4")
                    t = dict(ms=k_ms, host_ms=cuda_ms(kern), plain_ms=p_ms,
                             plain_host_ms=cuda_ms(plain), module_ms=u_ms,
                             module_host_ms=cuda_ms(module), per_forward=blocks)
                t["bound_ms"], t["bound_by"] = k4_bound_ms(W, ws, C, heads, kernels, dtype)
                times[name] = t
                print(f"k4 time {name} bf16 W={W} (device, CUDA graph, median of 3 "
                      f"interleaved rounds; CUDA events in parentheses): kernel {t['ms']:.4f} "
                      f"ms ({t['host_ms']:.4f}), plain {t['plain_ms']:.4f} ms "
                      f"({t['plain_host_ms']:.4f}), unfused plain-route CGA module "
                      f"{t['module_ms']:.4f} ms ({t['module_host_ms']:.4f}; no single library "
                      f"call computes the cascade), bound {t['bound_ms']:.4f} ms "
                      f"({t['bound_by']}); kernel / bound {t['ms'] / t['bound_ms']:.1f}x "
                      f"[{card_info()}]")
    for model, batch in EVIT_PATHS:
        tot = {k: sum(times[n][k] * times[n]["per_forward"] for n, *_ in EVIT_STAGES[model])
               for k in ("ms", "host_ms", "plain_ms", "module_ms", "module_host_ms", "bound_ms")}
        print(f"k4 per {model} bf16 bs{batch} forward (device, CUDA graph; CUDA events in "
              f"parentheses): kernel {tot['ms']:.4f} ms ({tot['host_ms']:.4f}), plain "
              f"{tot['plain_ms']:.4f}, unfused module {tot['module_ms']:.4f} "
              f"({tot['module_host_ms']:.4f}), bound {tot['bound_ms']:.4f} ms [{card_info()}]")
    return worst_bf16, times


def phase_evit_graph(name: str, batch: int) -> dict:
    """An EfficientViT eval forward by CUDA-graph replay on each attention
    route, 3 interleaved rounds, so the host's issue is out of the time; the
    cached folds are warmed first. The captured cascade forward holds one K4
    launch per attention block."""
    dtype = torch.bfloat16
    model = create_model(name, device="cuda", dtype=dtype)
    model.load_state_dict(seeded_state_dict(model, 0))
    x = smooth_images(torch.Generator("cuda").manual_seed(2), batch).to(dtype)
    blocks = sum(isinstance(m, CascadedGroupAttention) for m in model.modules())
    routes = ("cascade", "core", "plain")

    def forward(route):
        def run():
            model.set_attn_kernel(route)
            return model(x)
        return run
    with torch.inference_mode():
        for route in routes:
            forward(route)()                     # the folds, cached
        torch.cuda.synchronize()
        n0 = cga.LAUNCHES
        rounds = graph_rounds(*(forward(r) for r in routes))
    # graph_ms runs fn once and captures it 10 times a round
    check(cga.LAUNCHES - n0 == 3 * 11 * blocks,
          f"{name}: {cga.LAUNCHES - n0} K4 launches issued for the cascade graphs")
    ms = {r: statistics.median(t) for r, t in zip(routes, rounds)}
    print(f"graph {name} bf16 B={batch} eval forward (device, CUDA graph, 3 interleaved rounds "
          f"cascade/core/plain): " + ", ".join(
              f"{r} {ms[r]:.4f} ms (rounds {' / '.join(f'{v:.4f}' for v in t)})"
              for r, t in zip(routes, rounds)) + f" [{card_info()}]")
    return ms


def phase_evit_golden() -> None:
    """EfficientViT-M5 fp32 B=2 on seeded weights against the JAX logits,
    on each attention route, TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = np.load(EVIT_GOLDEN)
    x = np.random.default_rng(int(g["input_seed"])).standard_normal(
        (2, 224, 224, 3)).astype(np.float32)
    m = create_model("efficientvit_m5", device="cuda", dtype=torch.float32)
    m.load_state_dict(seeded_state_dict(m, int(g["weight_seed"])))
    # fp32 with TF32 off; cuDNN/cuBLAS/K4/K5 sum in other orders than the
    # CPU reference (the port matches it to ~1e-6 on the CPU)
    lim = 1e-3
    for route in ("cascade", "core", "plain"):
        m.set_attn_kernel(route)
        cga.LAUNCHES = cga_core.LAUNCHES = 0
        logits = predict(m, torch.from_numpy(x)).cpu().numpy()
        err = float(np.abs(logits - g["logits"]).max())
        print(f"golden efficientvit_m5 fp32 B=2 route {route} vs JAX logits: "
              f"max_abs_err={err:.3e} bound={lim:.1e} (K4/K5 launches "
              f"{cga.LAUNCHES}/{cga_core.LAUNCHES})")
        check(logits.shape == (2, 1000) and bool(np.isfinite(logits).all()),
              f"golden logits ({route})")
        check(err <= lim, f"EfficientViT golden ({route}) err {err} > {lim}")


def bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at |t| (elementwise)."""
    return 2.0 ** (torch.floor(torch.log2(t.abs().clamp_min(2.0 ** -126))) - 7)


def top1_agreement(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, float, float]:
    """(agreement on all images, share of images whose top-2 margin in `ref`
    is above 4 bf16 ulps at its top logit, agreement on those)."""
    top2 = ref.topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > 4 * bf16_ulp(top2[:, 0])
    same = got.argmax(-1) == ref.argmax(-1)
    return (same.float().mean().item(), decided.float().mean().item(),
            same[decided].float().mean().item())


def phase_evit_main(name: str, batch: int) -> dict:
    """An EfficientViT eval main path on its three attention routes; returns
    each route's (K4, K5) launches in its first run of predict+throughput."""
    dtype = torch.bfloat16
    gen = torch.Generator("cuda").manual_seed(2)
    model = create_model(name, device="cuda", dtype=dtype)
    model.load_state_dict(seeded_state_dict(model, 0))
    cgas = [m for m in model.modules() if isinstance(m, CascadedGroupAttention)]
    blocks, heads = len(cgas), sum(m.heads for m in cgas)
    want = {"efficientvit_m5": (8, 28), "efficientvit_m0": (6, 24)}[name]
    check((blocks, heads) == want, f"{name}: {blocks} blocks, {heads} heads, want {want}")
    x = smooth_images(gen, batch).to(dtype)
    warmup, iters = 3, 10
    runs = 1 + warmup + iters
    launches, logits, ips = {}, {}, {}
    for route, per in (("cascade", (blocks, 0)), ("core", (0, heads)), ("plain", (0, 0))):
        model.set_attn_kernel(route)
        wa.LAUNCHES = wa.BWD_LAUNCHES = cga.LAUNCHES = cga_core.LAUNCHES = 0
        logits[route] = predict(model, x)
        per_forward = (cga.LAUNCHES, cga_core.LAUNCHES)
        ips[route] = [throughput(model, batch, 224, dtype, iters, warmup)]
        launches[route] = (cga.LAUNCHES, cga_core.LAUNCHES)
        check(per_forward == per, f"{name} {route}: K4/K5 launches per forward "
                                  f"{per_forward}, want {per}")
        check(launches[route] == (runs * per[0], runs * per[1]),
              f"{name} {route}: K4/K5 launches {launches[route]} in the main path")
        check(wa.LAUNCHES == wa.BWD_LAUNCHES == 0, f"{name} launched K1/K2")
        check(logits[route].shape == (batch, 1000) and bool(torch.isfinite(logits[route]).all()),
              f"{name} {route}: logits not finite")
    for route in ("plain", "core", "cascade"):
        model.set_attn_kernel(route)
        ips[route].append(throughput(model, batch, 224, dtype, iters, warmup))
    card = card_info()
    # logits: the routes round at other points (BN folded into bf16 weights
    # for K4; scores and exp(s - max) rounded to bf16 on the plain route),
    # and the differences pass ~45 bf16 residual adds: 8 ulps at the largest
    lim = 8 * bf16_ulp(logits["plain"].abs().max()).item()
    for route in ("cascade", "core"):
        # seeded weights give a near-constant classifier (logits vary by
        # ~0.03 across images, a bf16 ulp is 0.008 at |logit| ~ 2): the
        # top-1 check counts the images whose plain-route top-2 margin is
        # above 4 bf16 ulps, where a correct route cannot flip the answer
        agree, decided, agree_decided = top1_agreement(logits[route], logits["plain"])
        err = (logits[route] - logits["plain"]).abs().max().item()
        print(f"main {name} bf16 B={batch} route {route}: K4/K5 launches per forward="
              f"{launches[route][0] // runs}/{launches[route][1] // runs}, top-1 agreement "
              f"vs plain={agree_decided:.4f} on the {round(decided * batch)} images with a "
              f"margin above 4 bf16 ulps (need >= 0.99 on >= 100), {agree:.4f} on all "
              f"{batch} (not checked), logits max_abs_err={err:.3e} bound={lim:.3e} "
              f"(max |logit| {logits['plain'].abs().max().item():.3f})")
        check(decided * batch >= 100 and agree_decided >= 0.99,
              f"{name} {route}: top-1 agreement {agree_decided} on "
              f"{round(decided * batch)} images")
        check(err <= lim, f"{name} {route}: logits err {err} > {lim}")
    print(f"main throughput {name} bf16 B={batch} (order cascade, core, plain, plain, core, "
          f"cascade): cascade (K4) {ips['cascade'][0]:.1f} / {ips['cascade'][1]:.1f} img/s, "
          f"core (K5) {ips['core'][0]:.1f} / {ips['core'][1]:.1f} img/s, plain "
          f"{ips['plain'][0]:.1f} / {ips['plain'][1]:.1f} img/s [{card}]")
    return launches


def dw_inputs(gen, B, H, W, C, stride, dtype):
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    x = torch.randn(B, H, W, C, generator=gen, device="cuda").to(dtype)
    w9 = (torch.randn(9, C, generator=gen, device="cuda") / 3).to(dtype)
    dy = torch.randn(B, Ho, Wo, C, generator=gen, device="cuda").to(dtype)
    return x, w9, dy


def dw_bound(dtype, ref: torch.Tensor, rel: float) -> float:
    """bf16: one ulp at the largest |ref| (the kernel rounds the plain
    version's fp32 products and sums, taken in its order, once); fp32: `rel`
    of the largest |ref|."""
    top = ref.float().abs().max().item()
    return 2.0 ** (np.floor(np.log2(top)) - 7) if dtype == torch.bfloat16 else rel * top


def dw_bound_ms(B, H, W, C, stride, dtype, kind: str) -> tuple[float, str]:
    """Least time of a depthwise launch: x (and dy) read once, y (or dx, dw)
    written once; 9 multiply-adds per output element for y, per dy element
    for dx and for dw."""
    e = torch.finfo(dtype).bits // 8
    n_in = B * H * W * C
    n_out = B * ((H - 1) // stride + 1) * ((W - 1) // stride + 1) * C
    if kind == "fwd":
        nbytes, flops = (n_in + n_out + 9 * C) * e, 18 * n_out
    elif kind == "bwd":
        nbytes, flops = (2 * n_in + n_out + 9 * C) * e + 9 * C * 4, 36 * n_out
    else:                                                      # weight grad
        nbytes, flops = (n_in + n_out) * e + 9 * C * 4, 18 * n_out
    return roofline_ms(nbytes, flops, dtype)


def dw_library(x, w9, dy, stride):
    """cuDNN's calls for the same functions on the NCHW (channels_last) views:
    forward, (dx, dw) and dw alone."""
    C = x.shape[-1]
    xn, dyn = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
    w = w9.t().reshape(C, 1, 3, 3).contiguous()

    def bwd(mask):
        return torch.ops.aten.convolution_backward(dyn, xn, w, None, [stride, stride], [1, 1],
                                                   [1, 1], False, [0, 0], C, mask)
    return (lambda: F.conv2d(xn, w, None, stride, 1, 1, C),
            lambda: bwd([True, True, False]), lambda: bwd([False, True, False]))


def phase_dw(gen) -> tuple[dict, dict]:
    """K7/K8/K9 against their plain versions at the M5 and TinyViT-21M
    depthwise shapes, at odd stride-2 maps and at Cream's 19 site shapes
    (bs128), bf16 and fp32; dw bits on two launches; bf16 times at the M5
    and TinyViT sites. Returns the worst bf16 errors by kernel and the times
    by shape."""
    worst = dict.fromkeys(dwconv.LAUNCHES, 0.0)
    times = {}
    for name, B, H, W, C, stride, per in DW_M5 + DW_TINYVIT + DW_S2_ODD + DW_CREAM:
        fwd, bwd = ("k7_fwd", "k7_bwd") if stride == 1 else ("k9_fwd", "k9_bwd")
        for dtype in (torch.bfloat16, torch.float32):
            x, w9, dy = dw_inputs(gen, B, H, W, C, stride, dtype)
            with torch.no_grad():
                y = dwconv.dw_conv3x3_fwd(x, w9, stride)
                dx, dw = dwconv.dw_conv3x3_bwd(x, dy, w9, stride)
                dx2, dw2 = dwconv.dw_conv3x3_bwd(x, dy, w9, stride)
                dw8 = dwconv.dw_wgrad(x, dy) if stride == 1 else None
                torch.cuda.synchronize()
                y_ref = dwconv.dw_conv3x3_ref(x, w9, stride)
                dx_ref, dw_ref = dwconv.dw_conv3x3_bwd_ref(x, dy, w9, stride)
            errs = {"y": (y.float() - y_ref.float()).abs().max().item(),
                    "dx": (dx.float() - dx_ref.float()).abs().max().item(),
                    "dw": (dw - dw_ref).abs().max().item()}
            lims = {"y": dw_bound(dtype, y_ref, 1e-6), "dx": dw_bound(dtype, dx_ref, 1e-6),
                    "dw": 1e-5 * dw_ref.abs().max().item()}
            same = torch.equal(dw, dw2) and torch.equal(dx, dx2)
            same8 = dw8 is None or torch.equal(dw8, dw)
            print(f"dw {name} B={B} {H}x{W} C={C} stride={stride} "
                  f"{str(dtype).split('.')[-1]}: " + ", ".join(
                      f"{k} max_abs_err={errs[k]:.3e} bound={lims[k]:.3e}" for k in errs)
                  + f"; (y, dx) bit-identical to plain: {torch.equal(y, y_ref)}, "
                  f"{torch.equal(dx, dx_ref)}; two launches bit-identical: {same}"
                  + ("" if dw8 is None else f"; K8 dw == K7 dw: {same8}"))
            for k in errs:
                check(errs[k] <= lims[k], f"dw {name} {dtype} {k} err {errs[k]} > {lims[k]}")
            check(same and same8, f"dw {name} {dtype}: launches differ")
            if dtype != torch.bfloat16:
                continue
            worst[fwd] = max(worst[fwd], errs["y"])
            worst[bwd] = max(worst[bwd], errs["dx"])
            if stride == 1:
                worst["k8"] = max(worst["k8"], errs["dw"])
            if per == 0:
                continue
            lib_fwd, lib_bwd, lib_wg = dw_library(x, w9, dy, stride)
            # device times (CUDA graphs): at the 16-channel sites a launch
            # is shorter than the host's cost of issuing it
            n0 = dict(dwconv.LAUNCHES)
            with torch.no_grad():
                t = {"fwd": dict(ms=graph_ms(lambda: dwconv.dw_conv3x3_fwd(x, w9, stride)),
                                 host_ms=cuda_ms(lambda: dwconv.dw_conv3x3_fwd(x, w9, stride)),
                                 plain_ms=graph_ms(lambda: dwconv.dw_conv3x3_ref(x, w9, stride)),
                                 library_ms=graph_ms(lib_fwd)),
                     "bwd": dict(ms=graph_ms(lambda: dwconv.dw_conv3x3_bwd(x, dy, w9, stride)),
                                 host_ms=cuda_ms(lambda: dwconv.dw_conv3x3_bwd(x, dy, w9, stride)),
                                 plain_ms=graph_ms(lambda: dwconv.dw_conv3x3_bwd_ref(
                                     x, dy, w9, stride)),
                                 library_ms=graph_ms(lib_bwd))}
                if stride == 1:
                    t["wgrad"] = dict(ms=graph_ms(lambda: dwconv.dw_wgrad(x, dy)),
                                      host_ms=cuda_ms(lambda: dwconv.dw_wgrad(x, dy)),
                                      plain_ms=graph_ms(lambda: dwconv.dw_wgrad_ref(x, dy)),
                                      library_ms=graph_ms(lib_wg))
            # the graphs captured each wrapper's launch once per call
            check(dwconv.LAUNCHES[fwd] > n0[fwd], f"dw {name}: the timing did not launch {fwd}")
            for kind, r in t.items():
                r["bound_ms"], r["bound_by"] = dw_bound_ms(B, H, W, C, stride, dtype, kind)
                print(f"dw time {name} {kind} bf16 B={B} (device, CUDA graph): kernel "
                      f"{r['ms']:.4f} ms ({r['host_ms']:.4f} ms a call issued from the host), "
                      f"plain {r['plain_ms']:.4f} ms, library (cuDNN) {r['library_ms']:.4f} ms, "
                      f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}) [{card_info()}]")
            times[name] = t
            if stride == 2:
                r = t["bwd"]
                print(f"K9 bwd {name} bf16 (B, H, W, C) = {(B, H, W, C)}, plan "
                      f"{tuple(dwconv.tile_plan_s2(x.shape, dtype))}: kernel {r['ms']:.4f} ms, "
                      f"plain {r['plain_ms']:.4f}, cuDNN {r['library_ms']:.4f}, bound "
                      f"{r['bound_ms']:.4f} ({r['bound_by']}); kernel / bound "
                      f"{r['ms'] / r['bound_ms']:.2f}x, kernel / cuDNN "
                      f"{r['ms'] / r['library_ms']:.3f}x [{card_info()}]")
    for key, kind, stride in (("k7_fwd", "fwd", 1), ("k7_bwd", "bwd", 1), ("k8", "wgrad", 1),
                              ("k9_fwd", "fwd", 2), ("k9_bwd", "bwd", 2)):
        for model, sites in (("EfficientViT-M5 bf16 bs512", DW_M5),
                             ("TinyViT-21M-224 bf16 bs256", DW_TINYVIT)):
            step = per_step(times, sites, kind, stride)
            n = sum(per for *_, s, per in sites if s == stride)
            print(f"dw {key} per {model} train step ({n} sites): kernel {step['ms']:.4f} ms "
                  f"(issued one by one from the host {step['host_ms']:.4f} ms), plain "
                  f"{step['plain_ms']:.4f} ms, library {step['library_ms']:.4f} ms, bound "
                  f"{step['bound_ms']:.4f} ms [{card_info()}]")
    return worst, times


def per_step(times: dict, sites: list, kind: str, stride: int) -> dict:
    """`phase_dw`'s per-site times of one kind summed over a train step's
    sites of one stride (each site's time times its count per step)."""
    return {k: sum(times[n][kind][k] * per for n, *_, s, per in sites if s == stride)
            for k in ("ms", "host_ms", "plain_ms", "library_ms", "bound_ms")}


def phase_dw_grads(gen) -> None:
    """fp32 at a small shape: each depthwise autograd.Function's grads
    against autograd of the plain forward."""
    for fn, stride in ((dwconv.dw_conv3x3_fused, 1), (dwconv.dw_conv3x3_wg, 1),
                       (dwconv.dw_conv3x3s2_fused, 2)):
        x, w9, dy = dw_inputs(gen, 2, 14, 14, 48, stride, torch.float32)
        leaves = [x.clone().requires_grad_(), w9.clone().requires_grad_()]
        got = torch.autograd.grad(fn(*leaves), leaves, dy)
        plain = [x.clone().requires_grad_(), w9.clone().requires_grad_()]
        want = torch.autograd.grad(dwconv.dw_conv3x3_ref(*plain, stride), plain, dy)
        errs = [((g - w).abs().max() / w.abs().max()).item() for g, w in zip(got, want)]
        print(f"grads {fn.__name__} fp32 vs autograd of the plain forward: max_abs_err / "
              f"max |grad| for x, w9 = {', '.join(f'{e:.2e}' for e in errs)} (bound 1e-5)")
        check(max(errs) <= 1e-5, f"{fn.__name__} grads: {errs}")


def m5_dw_launches(route: str) -> dict:
    """K7/K8/K9 launches of one M5 train step at 224 on `route`: 32 stride-1
    sites, 1 stride-2 site with an even map."""
    want = {"fused": {"k7_fwd": 32, "k7_bwd": 32, "k9_fwd": 1, "k9_bwd": 1},
            "wgrad": {"k8": 32}}.get(route, {})
    return {k: want.get(k, 0) for k in dwconv.LAUNCHES}


def tv_dw_launches(route: str) -> dict:
    """K7/K8/K9 launches of one TinyViT-21M-224 train step at 224 on
    `route`: 12 stride-1 sites (2 MBConv conv2, 10 local_conv), 3 stride-2
    PatchMerging sites."""
    want = {"fused": {"k7_fwd": 12, "k7_bwd": 12, "k9_fwd": 3, "k9_bwd": 3},
            "wgrad": {"k8": 12}}.get(route, {})
    return {k: want.get(k, 0) for k in dwconv.LAUNCHES}


def phase_tv_dw_train() -> dict:
    """TinyViT-21M-224 bf16 bs256 train steps (AdamW as the trainer builds
    it, drop path 0.2) with every depthwise site on "library" and on
    "fused" (K7 at its 12 stride-1 sites, K9 at its 3 stride-2 sites), from
    the same weights and batch: launches per step, the first step's loss,
    train img/s in 4 interleaved rounds. Returns the "fused" route's
    launches."""
    dtype, routes = torch.bfloat16, ("library", "fused")
    gen = torch.Generator("cuda").manual_seed(7)
    models = {}
    for route in routes:
        models[route] = create_model("tiny_vit_21m_224", device="cuda", dtype=dtype)
        models[route].load_state_dict(seeded_state_dict(models[route], 0))
        set_dw_kernel(models[route], route)
    x = smooth_images(gen, BATCH).to(dtype)
    labels = torch.randint(0, 1000, (BATCH,), generator=gen, device="cuda")
    batch = {"image": x, "label": F.one_hot(labels, 1000).float()}
    step = make_train_step(loss_fn=soft_target_ce)
    warmup, iters = 3, 10
    first, ips, launches = {}, {r: [] for r in routes}, {}
    for route in routes:
        state = TrainState(models[route], make_adamw(
            1e-3, weight_decay=0.05, clip_grad=5.0, params=dict(models[route].named_parameters())))
        dwconv.reset_launches()
        _, first[route] = step(state, batch, 0)
        torch.cuda.synchronize()
        want = tv_dw_launches(route)
        check(dict(dwconv.LAUNCHES) == want,
              f"tiny_vit_21m_224 {route}: K7/K8/K9 launches per step {dwconv.LAUNCHES}, want {want}")
    dwconv.reset_launches()
    for order in (routes, routes[::-1], routes, routes[::-1]):
        for route in order:
            ips[route].append(train_throughput(models[route], BATCH, 224, dtype, iters, warmup))
    launches = dict(dwconv.LAUNCHES)
    runs = 4 * (warmup + iters)
    check(launches == {k: v * runs for k, v in tv_dw_launches("fused").items()},
          f"tiny_vit_21m_224: K7/K8/K9 launches {launches} in the timed train steps")
    l_ref, l_k = float(first["library"]["loss"]), float(first["fused"]["loss"])
    g_ref, g_k = float(first["library"]["grad_norm"]), float(first["fused"]["grad_norm"])
    loss_lim = 2 * 2.0 ** (np.floor(np.log2(l_ref)) - 7)
    median = {r: statistics.median(v) for r, v in ips.items()}
    print(f"train tiny_vit_21m_224 bf16 B={BATCH} dw route fused: K7/K8/K9 launches per step "
          f"{tv_dw_launches('fused')}, library none; step 1 vs library: loss {l_k:.5f} vs "
          f"{l_ref:.5f} (|diff| {abs(l_k - l_ref):.2e}, bound {loss_lim:.2e}), grad_norm "
          f"{g_k:.4f} vs {g_ref:.4f} (rel diff {abs(g_k - g_ref) / g_ref:.2e}, bound 2e-2)")
    print(f"train throughput tiny_vit_21m_224 bf16 B={BATCH} dw routes (rounds in the orders "
          f"library, fused / reversed / forward / reversed): " + "; ".join(
              f"{r} {' / '.join(f'{v:.1f}' for v in ips[r])} img/s (median {median[r]:.1f})"
              for r in routes) + f"; fused / library {median['fused'] / median['library']:.4f} "
          f"[{card_info()}]")
    check(np.isfinite(l_k) and abs(l_k - l_ref) <= loss_lim,
          f"tiny_vit_21m_224 fused vs library loss {l_k} vs {l_ref}")
    check(abs(g_k - g_ref) <= 2e-2 * g_ref,
          f"tiny_vit_21m_224 fused vs library grad_norm {g_k} vs {g_ref}")
    return launches


def phase_evit_train_golden() -> None:
    """One fp32 EfficientViT-M5 train step (B=8) on each depthwise route
    against the JAX package's, stored by tests/test_torch_efficientvit_train.py;
    TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = np.load(EVIT_TRAIN_GOLDEN)
    n = len(g["names"])
    rng = np.random.default_rng(int(g["input_seed"]))
    B = 8
    x = rng.standard_normal((B, 224, 224, 3)).astype(np.float32)
    y = np.eye(1000, dtype=np.float32)[rng.integers(0, 1000, B)]
    batch = {"image": torch.from_numpy(x).cuda(), "label": torch.from_numpy(y).cuda()}
    sd = None
    for route in DW_ROUTES:
        m = create_model("efficientvit_m5", device="cuda", dtype=torch.float32, dw_kernel=route)
        sd = sd or seeded_state_dict(m, int(g["weight_seed"]))
        m.load_state_dict(sd)
        dwconv.reset_launches()
        loss, _, grads = loss_and_grads(m, batch, soft_target_ce)
        torch.cuda.synchronize()
        check(dict(dwconv.LAUNCHES) == m5_dw_launches(route),
              f"train golden {route}: launches {dwconv.LAUNCHES}")
        loss_err = abs(float(loss) - float(g["loss"])) / float(g["loss"])
        gn_err = abs(float(global_norm(grads.values())) - float(g["grad_norm"])) / float(g["grad_norm"])
        check(sorted(grads) == list(g["names"]), "EfficientViT train golden: param names differ")
        got = np.asarray([grads[k].norm().item() for k in g["names"]])
        floor = 1e-7 * float(g["grad_norm"])
        diff = np.abs(got - g["grad_norms"])
        above = g["grad_norms"] > 100 * floor
        worst = float((diff[above] / g["grad_norms"][above]).max())
        # loss and grad norm: fp32 sums in other orders (the CPU port: 2e-7,
        # 1e-5); per tensor 5e-3: ReLU inputs within fp32 noise of 0 move
        # some attention-BN and first-layer grads by ~1e-3 under rounding alone
        print(f"train golden efficientvit_m5 fp32 B={B} route {route} vs JAX: loss rel err "
              f"{loss_err:.2e} (bound 1e-4), grad_norm rel err {gn_err:.2e} (bound 1e-4), "
              f"per-tensor grad norms worst rel err {worst:.2e} over the {int(above.sum())} of "
              f"{n} tensors above 100x the noise floor (bound 5e-3); K7/K8/K9 launches "
              f"{dict(dwconv.LAUNCHES)}")
        check(loss_err <= 1e-4, f"EfficientViT train golden ({route}) loss rel err {loss_err}")
        check(gn_err <= 1e-4, f"EfficientViT train golden ({route}) grad_norm rel err {gn_err}")
        check(bool((diff <= 5e-3 * g["grad_norms"] + floor).all()),
              f"EfficientViT train golden ({route}) per-tensor grad norms")


def phase_evit_train() -> dict:
    """The EfficientViT train main path: M5 bf16 bs512, AdamW as the trainer
    builds it, on each depthwise route; returns each route's launches."""
    dtype, batch_size, name = torch.bfloat16, 512, "efficientvit_m5"
    gen = torch.Generator("cuda").manual_seed(3)
    sd = None
    models = {}
    for route in DW_ROUTES:
        models[route] = create_model(name, device="cuda", dtype=dtype, dw_kernel=route)
        sd = sd or seeded_state_dict(models[route], 0)
        models[route].load_state_dict(sd)
    s1 = sum(isinstance(c, ConvBN) and c.is_dw3x3() and c.stride == 1
             for c in models["fused"].modules())
    check(s1 == 32, f"{name}: {s1} stride-1 depthwise 3x3 sites, want 32")
    x = smooth_images(gen, batch_size).to(dtype)
    labels = torch.randint(0, 1000, (batch_size,), generator=gen, device="cuda")
    batch = {"image": x, "label": F.one_hot(labels, 1000).float()}

    def new_state(m):
        return TrainState(m, make_adamw(1e-3, weight_decay=0.05, clip_grad=5.0,
                                        params=dict(m.named_parameters())))

    step = make_train_step(loss_fn=soft_target_ce)
    n_steps, warmup, iters = 10, 3, 10
    launches, first, losses, peak, ips = {}, {}, {}, {}, {}
    for route in DW_ROUTES:
        state = new_state(models[route])
        torch.cuda.reset_peak_memory_stats()
        dwconv.reset_launches()
        wa.LAUNCHES = wa.BWD_LAUNCHES = cga.LAUNCHES = cga_core.LAUNCHES = 0
        losses[route] = []
        for i in range(n_steps):
            state, metrics = step(state, batch, 0)
            losses[route].append(float(metrics["loss"]))
            if i == 0:
                first[route] = metrics
                per_step = dict(dwconv.LAUNCHES)
        peak[route] = torch.cuda.max_memory_allocated() / 2 ** 30
        ips[route] = [train_throughput(models[route], batch_size, 224, dtype, iters, warmup)]
        launches[route] = dict(dwconv.LAUNCHES)
        want = m5_dw_launches(route)
        check(per_step == want, f"{name} {route}: K7/K8/K9 launches per step {per_step}, "
                                f"want {want}")
        runs = n_steps + warmup + iters
        check(launches[route] == {k: v * runs for k, v in want.items()},
              f"{name} {route}: K7/K8/K9 launches {launches[route]} in the train path")
        check(cga.LAUNCHES == cga_core.LAUNCHES == wa.LAUNCHES == wa.BWD_LAUNCHES == 0,
              f"{name} {route}: a train step launched K1/K2/K4/K5")
        check(all(np.isfinite(losses[route])), f"{name} {route}: train loss not finite")
        check(losses[route][-1] < losses[route][0], f"{name} {route}: loss did not fall: "
                                                    f"{losses[route]}")
    # the host issues ~5,400 launches a step and sets the pace; its noise is
    # large, so each route is timed four times, interleaved
    for order in (DW_ROUTES[::-1], DW_ROUTES, DW_ROUTES[::-1]):
        for route in order:
            ips[route].append(train_throughput(models[route], batch_size, 224, dtype, iters,
                                               warmup))
    card = card_info()
    l_ref, g_ref = float(first["library"]["loss"]), float(first["library"]["grad_norm"])
    # bf16 logits and log-softmax: the loss terms sit on a bf16 grid (2 ulps
    # at the loss); the grads flow through bf16 activations rounded at other
    # points (2%)
    loss_lim = 2 * 2.0 ** (np.floor(np.log2(l_ref)) - 7)
    for route in DW_ROUTES:
        l_k, g_k = float(first[route]["loss"]), float(first[route]["grad_norm"])
        print(f"train {name} bf16 B={batch_size} dw route {route}: K7/K8/K9 launches per step "
              f"{m5_dw_launches(route)}, K4/K5 0/0; loss over {n_steps} steps on one batch: "
              f"{', '.join(f'{v:.4f}' for v in losses[route])}; step 1 vs library: loss "
              f"{l_k:.5f} vs {l_ref:.5f} (|diff| {abs(l_k - l_ref):.2e}, bound {loss_lim:.2e}), "
              f"grad_norm {g_k:.4f} vs {g_ref:.4f} (rel diff {abs(g_k - g_ref) / g_ref:.2e}, "
              f"bound 2e-2); peak memory {peak[route]:.2f} GiB")
        check(abs(l_k - l_ref) <= loss_lim, f"{route} vs library loss {l_k} vs {l_ref}")
        check(abs(g_k - g_ref) <= 2e-2 * g_ref, f"{route} vs library grad_norm {g_k} vs {g_ref}")
    median = {r: statistics.median(v) for r, v in ips.items()}
    print(f"train throughput {name} bf16 B={batch_size} (rounds in the orders library, "
          f"fused, wgrad / reversed / forward / reversed): " + "; ".join(
              f"{r} {' / '.join(f'{v:.1f}' for v in ips[r])} img/s (median {median[r]:.1f})"
              for r in DW_ROUTES) + f"; highest median: {max(median, key=median.get)} [{card}]")
    # eval with the depthwise convs on the library conv and on K7/K9
    # (cascade attention route)
    m = models["library"].eval()
    eval_ips = {r: [] for r in ("library", "fused", "fused", "library")}
    for r in ("library", "fused", "fused", "library"):
        set_dw_kernel(m, r)
        eval_ips[r].append(throughput(m, batch_size, 224, dtype, 10, 3))
    set_dw_kernel(m, "library")
    print(f"eval throughput {name} bf16 B={batch_size} cascade attention (order library, "
          f"fused, fused, library): dw library {eval_ips['library'][0]:.1f} / "
          f"{eval_ips['library'][1]:.1f} img/s, dw fused {eval_ips['fused'][0]:.1f} / "
          f"{eval_ips['fused'][1]:.1f} img/s [{card}]")
    return launches


def seeded_mbconv(C: int, hid: int, dtype, seed: int) -> MBConv:
    m = MBConv(C, hid / C, device="cuda", dtype=dtype).eval()
    m.load_state_dict(seeded_state_dict(m, seed))
    return m


def k6_bound_ms(B, H, W, C, hid, dtype) -> tuple[float, str]:
    """K6's least time: x read and y written once, the folded weights read
    once; the expand and project products and the nine depthwise taps."""
    e = torch.finfo(dtype).bits // 8
    pix = B * H * W
    nbytes = 2 * pix * C * e + 2 * C * hid * e + (11 * hid + C) * 4
    return roofline_ms(nbytes, pix * (4 * C * hid + 18 * hid), dtype)


# the bf16 kernel's tanh-form GELU (`gelu<false>` in csrc/mbconv.cu) as it
# executes: 9 fp32 lane operations (0.5x; the exponent's multiply, FMA and
# multiply; 1 + e; the FMA 1 - 2r; copysign; 1 + t; the last multiply) and
# 2 MUFU operations (ex2.approx, rcp.approx)
GELU_LANE_OPS, GELU_MUFU_OPS = 9, 2


def k6_floor_ms(B, H, W, C, hid) -> float:
    """K6's CUDA-core floor: the work of the function (not the kernel's halo
    recompute) that cannot go to the tensor cores, at `CUDA_CORE_CLOCK`
    (assumed). Per hidden element: the expand's bias add, the depthwise's
    18 fp32 operations (multiply and add apart, as the plain version rounds
    them) and two GELUs; per output channel the bias and residual adds and
    a GELU. The larger of the fp32 lanes' time and the MUFU's."""
    pix = B * H * W
    lane = pix * (hid * (1 + 18 + 2 * GELU_LANE_OPS) + C * (2 + GELU_LANE_OPS))
    mufu = pix * (hid * 2 + C) * GELU_MUFU_OPS
    return max(lane / CUDA_CORE_OPS, mufu / MUFU_OPS) * 1e3


def phase_k6(gen) -> tuple[float, dict]:
    """K6 against its plain version on seeded modules' folds at the stage-0
    shapes (bf16 at bs256, fp32 at bs32) and at maps its bf16 tiles cut
    raggedly, the same bits on two launches; bf16 device times of the
    kernel, the plain version and the unfused eval module by CUDA-graph
    replay in 3 interleaved rounds (CUDA-events times beside them), against
    the roofline bound and the CUDA-core floor."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    worst_bf16, times = 0.0, {}
    for name, B, H, W, C, hid, per in MBCONV_SHAPES + K6_RAGGED:
        for dtype, batch in ((torch.bfloat16, B), (torch.float32, min(B, 32))):
            m = seeded_mbconv(C, hid, dtype, seed=C)
            ops = mbconv.fold_mbconv(m, dtype)
            x = torch.randn(batch, H, W, C, generator=gen, device="cuda").to(dtype)
            with torch.inference_mode():
                out = mbconv.fused_mbconv(x, *ops)
                again = mbconv.fused_mbconv(x, *ops)
                torch.cuda.synchronize()
                ref = mbconv.fused_mbconv_ref(x, *ops)
            err = (out.float() - ref.float()).abs().max().item()
            lim = bound(dtype, ref.float())
            ulp = bf16_ulp(ref.float().abs().max().clamp_min(1.0)).item()
            same = torch.equal(out, again)
            print(f"k6 {name} B={batch} {H}x{W} C={C} HID={hid} "
                  f"{str(dtype).split('.')[-1]}: max_abs_err={err:.3e} bound={lim:.3e} "
                  f"({err / ulp:.2f} bf16 ulps at max |y|; elements differing: "
                  f"{(out != ref).float().mean().item():.2e}); two launches bit-identical: "
                  f"{same}")
            check(err <= lim, f"K6 {name} {dtype} err {err} > {lim}")
            check(out.shape == x.shape and bool(torch.isfinite(out).all()), f"K6 {name} output")
            check(same, f"K6 {name} {dtype}: two launches differ")
            if dtype != torch.bfloat16:
                continue
            worst_bf16 = max(worst_bf16, err)
            if not per:
                continue
            with torch.inference_mode():
                def kern():
                    return mbconv.fused_mbconv(x, *ops)

                def plain():
                    return mbconv.fused_mbconv_ref(x, *ops)

                def module():
                    return m(x)
                n0 = mbconv.LAUNCHES
                k_ms, p_ms, u_ms = interleaved_graph_ms(kern, plain, module)
                check(mbconv.LAUNCHES > n0, f"K6 {name}: the timing did not launch K6")
                t = dict(ms=k_ms, host_ms=cuda_ms(kern), plain_ms=p_ms,
                         plain_host_ms=cuda_ms(plain), module_ms=u_ms,
                         module_host_ms=cuda_ms(module), per_forward=per)
            t["bound_ms"], t["bound_by"] = k6_bound_ms(B, H, W, C, hid, dtype)
            t["floor_ms"] = k6_floor_ms(B, H, W, C, hid)
            times[name] = t
            print(f"k6 time {name} bf16 B={B} (device, CUDA graph, median of 3 interleaved "
                  f"rounds; CUDA events in parentheses): kernel {t['ms']:.4f} ms "
                  f"({t['host_ms']:.4f}), plain {t['plain_ms']:.4f} ms "
                  f"({t['plain_host_ms']:.4f}), unfused eval MBConv module (cuDNN 1x1 and "
                  f"depthwise convs, BN, GELU; no single library call computes the block) "
                  f"{t['module_ms']:.4f} ms ({t['module_host_ms']:.4f}), roofline bound "
                  f"{t['bound_ms']:.4f} ms ({t['bound_by']}), CUDA-core floor "
                  f"{t['floor_ms']:.4f} ms (at an assumed {CUDA_CORE_CLOCK / 1e9:.2f} GHz); "
                  f"per TinyViT forward ({per} launches) "
                  f"kernel {per * t['ms']:.4f} ms, module {per * t['module_ms']:.4f} ms "
                  f"[{card_info()}]")
    return worst_bf16, times


def k3_bound_ms(W, h, N, d, dtype) -> tuple[float, str]:
    """K3's least time: q, k, v and the bias read once, out written once;
    Q.K^T and P.V."""
    e = torch.finfo(dtype).bits // 8
    nbytes = 4 * W * h * N * d * e + h * N * N * 4
    return roofline_ms(nbytes, W * h * 2 * N * N * 2 * d, dtype)


def phase_k3(gen) -> tuple[float, dict, int]:
    """K3 against its plain version at the per-window shapes, bf16 and
    fp32; bf16 times of the kernel, the plain version and SDPA; then the
    BiasAttention main path. Returns the worst bf16 error, the times and
    the main path's K3 launches."""
    worst_bf16, times = 0.0, {}
    for name, W, h, N, d in K3_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (torch.randn(W, h, N, d, generator=gen, device="cuda").to(dtype)
                       for _ in range(3))
            bias = torch.randn(h, N, N, generator=gen, device="cuda") * 0.5
            with torch.inference_mode():
                out = bias_attention.fused_bias_attention(q, k, v, bias)
                torch.cuda.synchronize()
                ref = bias_attention.fused_bias_attention_ref(q, k, v, bias)
            err = (out.float() - ref.float()).abs().max().item()
            lim = bound(dtype, ref.float())
            print(f"k3 {name} W={W} heads={h} N={N} d={d} {str(dtype).split('.')[-1]}: "
                  f"max_abs_err={err:.3e} bound={lim:.3e} (elements differing: "
                  f"{(out != ref).float().mean().item():.2e})")
            check(err <= lim, f"K3 {name} {dtype} err {err} > {lim}")
            if dtype != torch.bfloat16:
                continue
            with torch.inference_mode():
                check(torch.equal(bias_attention.fused_bias_attention(q, k, v, bias), out),
                      f"K3 {name}: other bits on a second launch")
            worst_bf16 = max(worst_bf16, err)
            mask = bias.to(dtype)
            t = kernel_plain_library_ms(
                lambda: bias_attention.fused_bias_attention(q, k, v, bias),
                lambda: bias_attention.fused_bias_attention_ref(q, k, v, bias),
                lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask))
            t["bound_ms"], t["bound_by"] = k3_bound_ms(W, h, N, d, dtype)
            times[name] = t
            print(f"k3 time {name} bf16 W={W}: {format_times(t)}, library = SDPA with the "
                  f"bias as attn_mask [{card_info()}]")

    # BiasAttention at TinyViT-21M stage 1's windows: 4,096 windows of 7x7
    # tokens, dim 192, 6 heads of key_dim 32 (attn_ratio 1, as TinyViT's)
    _, W, h, N, d = K3_SHAPES[0]
    dim = h * d
    out = {}
    for dtype, batch in ((torch.bfloat16, W), (torch.float32, 256)):
        m = BiasAttention(dim, d, h, attn_ratio=1.0, resolution=(7, 7), device="cuda",
                          dtype=dtype).eval()
        m.load_state_dict(seeded_state_dict(m, 7))
        x = torch.randn(batch, N, dim, generator=gen, device="cuda").to(dtype)
        bias_attention.LAUNCHES = 0
        with torch.inference_mode():
            got = m(x)
            per_call = bias_attention.LAUNCHES
            if dtype == torch.bfloat16:
                ms = cuda_ms(lambda: m(x))
                launches = bias_attention.LAUNCHES
            m.use_kernel = False
            want = m(x)
            if dtype == torch.bfloat16:
                plain_ms = cuda_ms(lambda: m(x))
        check(per_call == 1, f"BiasAttention {dtype}: {per_call} K3 launches per call, want 1")
        top = want.float().abs().max().item()
        # bf16: the plain route rounds P and P.V where K3 does, its sums run
        # in other orders, and the projection sums 192 such channels: 4 ulps
        # at the largest |out|; fp32: 1e-5 of it
        lim = 4 * bf16_ulp(torch.tensor(max(top, 1.0))).item() \
            if dtype == torch.bfloat16 else 1e-5 * max(top, 1.0)
        err = (got.float() - want.float()).abs().max().item()
        out[dtype] = (err, lim)
        print(f"BiasAttention B={batch} N={N} dim={dim} heads={h} key_dim={d} "
              f"{str(dtype).split('.')[-1]}: K3 launches per call {per_call}, kernel route vs "
              f"plain route max_abs_err={err:.3e} bound={lim:.3e}"
              + (f"; {ms:.4f} ms a call (plain route {plain_ms:.4f} ms) [{card_info()}]"
                 if dtype == torch.bfloat16 else ""))
        check(err <= lim, f"BiasAttention {dtype}: err {err} > {lim}")
        check(bool(torch.isfinite(got).all()), "BiasAttention output not finite")
    return worst_bf16, times, launches


def phase_k10(gen) -> tuple[dict, dict]:
    """K10 against its plain versions, bit for bit, bf16 and fp32; bf16
    times of partition and reverse, plain and permute().contiguous()."""
    times = {}
    for name, B, Hm, ws, C, _ in K10_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(B, Hm, Hm, C, generator=gen, device="cuda").to(dtype)
            w = window_relayout.window_partition_kernel(x, ws)
            back = window_relayout.window_reverse_kernel(w, ws, (Hm, Hm))
            torch.cuda.synchronize()
            w_ref = window_relayout.window_partition_ref(x, ws)
            same = torch.equal(w, w_ref) and torch.equal(back, x) and \
                torch.equal(window_relayout.window_reverse_ref(w_ref, ws, (Hm, Hm)), back)
            print(f"k10 {name} B={B} {Hm}x{Hm} window={ws} C={C} "
                  f"{str(dtype).split('.')[-1]}: partition and reverse bit-identical to "
                  f"plain: {same}; contiguous: {w.is_contiguous() and back.is_contiguous()}")
            check(same and w.is_contiguous() and back.is_contiguous(), f"K10 {name} {dtype}")
            if dtype != torch.bfloat16:
                continue
            n = Hm // ws

            def lib_part():
                return x.view(B, n, ws, n, ws, C).permute(0, 1, 3, 2, 4, 5).contiguous()

            def lib_rev():
                return w.view(B, n, n, ws, ws, C).permute(0, 1, 3, 2, 4, 5).contiguous()
            def part():
                return window_relayout.window_partition_kernel(x, ws)

            def rev():
                return window_relayout.window_reverse_kernel(w, ws, (Hm, Hm))
            # device times (CUDA graphs): a launch here is about as short as
            # the host's cost of issuing it; a view captures no kernel
            t = {"partition": dict(ms=graph_ms(part), host_ms=cuda_ms(part),
                                   plain_ms=graph_ms(lambda: window_relayout.window_partition_ref(x, ws)),
                                   library_ms=graph_ms(lib_part)),
                 "reverse": dict(ms=graph_ms(rev), host_ms=cuda_ms(rev),
                                 plain_ms=graph_ms(lambda: window_relayout.window_reverse_ref(w, ws, (Hm, Hm))),
                                 library_ms=graph_ms(lib_rev))}
            b_ms, by = roofline_ms(2 * x.numel() * x.element_size(), 0, dtype)
            for kind, r in t.items():
                r["bound_ms"], r["bound_by"] = b_ms, by
                print(f"k10 time {name} {kind} bf16 B={B} (device, CUDA graph): kernel "
                      f"{r['ms']:.4f} ms ({r['host_ms']:.4f} ms a call issued from the host), "
                      f"plain {r['plain_ms']:.4f} ms, library (permute().contiguous()) "
                      f"{r['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({by}) [{card_info()}]")
            times[name] = t
    return times


def phase_k11(gen) -> dict:
    """K11 against its plain version (x.clone()), bit for bit, at the three
    stage-boundary tensors; bf16 times."""
    times = {}
    for name, B, Hm, C in K11_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(B, Hm, Hm, C, generator=gen, device="cuda").to(dtype)
            y = layout_pin.layout_pin(x)
            torch.cuda.synchronize()
            same = torch.equal(y, layout_pin.layout_pin_ref(x)) and y.data_ptr() != x.data_ptr()
            print(f"k11 {name} B={B} {Hm}x{Hm} C={C} {str(dtype).split('.')[-1]}: copy "
                  f"bit-identical to plain: {same}")
            check(same and y.is_contiguous(), f"K11 {name} {dtype}")
            if dtype != torch.bfloat16:
                continue
            b_ms, by = roofline_ms(2 * x.numel() * x.element_size(), 0, dtype)
            # device times (CUDA graphs), as for K10
            t = dict(ms=graph_ms(lambda: layout_pin.layout_pin(x)),
                     host_ms=cuda_ms(lambda: layout_pin.layout_pin(x)),
                     plain_ms=graph_ms(lambda: layout_pin.layout_pin_ref(x)),
                     library_ms=graph_ms(lambda: x.clone()), bound_ms=b_ms, bound_by=by)
            print(f"k11 time {name} bf16 B={B} (device, CUDA graph): kernel {t['ms']:.4f} ms "
                  f"({t['host_ms']:.4f} ms a call issued from the host), plain "
                  f"{t['plain_ms']:.4f} ms, library (x.clone()) {t['library_ms']:.4f} ms, "
                  f"bound {b_ms:.4f} ms ({by}) [{card_info()}]")
            times[name] = t
    return times


def phase_retime(gen) -> dict:
    """K11 against x.clone() at TinyViT-21M bs256's three stage inputs (one
    forward) and K9's forward and backward against cuDNN at TinyViT-21M
    bs256's three stride-2 sites (one train step), bf16, by CUDA-graph
    replay in 3 interleaved rounds; each round's sums and kernel / library
    ratio, and whether the kernel is more than 3% slower in every round."""
    pairs = {"k11": [], "k9_fwd": [], "k9_bwd": []}
    for name, B, Hm, C in K11_SHAPES:
        x = torch.randn(B, Hm, Hm, C, generator=gen, device="cuda").to(torch.bfloat16)
        pairs["k11"].append((lambda x=x: layout_pin.layout_pin(x), lambda x=x: x.clone(), 1))
    for name, B, H, W, C, stride, per in DW_TINYVIT:
        if stride != 2:
            continue
        x, w9, dy = dw_inputs(gen, B, H, W, C, stride, torch.bfloat16)
        lib_fwd, lib_bwd, _ = dw_library(x, w9, dy, 2)
        pairs["k9_fwd"].append((lambda x=x, w9=w9: dwconv.dw_conv3x3_fwd(x, w9, 2), lib_fwd, per))
        pairs["k9_bwd"].append((lambda x=x, w9=w9, dy=dy: dwconv.dw_conv3x3_bwd(x, dy, w9, 2),
                                lib_bwd, per))
    fns = [fn for p in pairs.values() for k, lib, _ in p for fn in (k, lib)]
    with torch.inference_mode():
        rounds = iter(graph_rounds(*fns, rounds=3))
    out = {}
    for key, p in pairs.items():
        kern, lib = [0.0] * 3, [0.0] * 3
        for _, _, per in p:
            kr, lr = next(rounds), next(rounds)
            kern = [a + per * b for a, b in zip(kern, kr)]
            lib = [a + per * b for a, b in zip(lib, lr)]
        ratio = [k / lb for k, lb in zip(kern, lib)]
        slower = all(r > 1.03 for r in ratio)
        what = ("K11 per TinyViT-21M-224 bf16 bs256 forward (3 stage inputs) vs x.clone()"
                if key == "k11" else
                f"K9 {key[3:]} per TinyViT-21M-224 bf16 bs256 train step (3 stride-2 sites) "
                f"vs cuDNN")
        print(f"retime {what} (device, CUDA graph, 3 interleaved rounds): kernel "
              + " / ".join(f"{v:.4f}" for v in kern) + " ms, library "
              + " / ".join(f"{v:.4f}" for v in lib) + " ms, kernel / library "
              + " / ".join(f"{v:.3f}" for v in ratio)
              + f"; more than 3% slower in every round: {slower} [{card_info()}]")
        out[key] = dict(ms=kern, library_ms=lib, slower=slower)
    return out


def set_tv_route(model: torch.nn.Module, route: str) -> None:
    set_mbconv_kernel(model, route in ("mbconv_kernel", "both"))
    model.pin_layouts = route in ("pin_layouts", "both")


def phase_tv_routes() -> tuple[int, int]:
    """TinyViT-21M-224 bf16 bs256 eval on the library, mbconv_kernel,
    pin_layouts and both routes; returns the K6 and K11 launches of the
    routes' main-path runs."""
    dtype = torch.bfloat16
    gen = torch.Generator("cuda").manual_seed(4)
    model = create_model("tiny_vit_21m_224", device="cuda", dtype=dtype)
    model.load_state_dict(seeded_state_dict(model, 0))
    n_mb = sum(isinstance(m, MBConv) for m in model.modules())
    check(n_mb == 2, f"{n_mb} MBConvs in TinyViT-21M, want 2")
    x = smooth_images(gen, BATCH).to(dtype)
    warmup, iters = 3, 20
    runs = 1 + warmup + iters
    logits, ips, k6, k11 = {}, {r: [] for r in TV_ROUTES}, 0, 0
    for route in TV_ROUTES:
        set_tv_route(model, route)
        mbconv.LAUNCHES = layout_pin.LAUNCHES = wa.LAUNCHES = 0
        logits[route] = predict(model, x)
        per = (mbconv.LAUNCHES, layout_pin.LAUNCHES)
        ips[route].append(throughput(model, BATCH, 224, dtype, iters, warmup))
        want = (2 if route in ("mbconv_kernel", "both") else 0,
                3 if route in ("pin_layouts", "both") else 0)
        check(per == want, f"{route}: K6/K11 launches per forward {per}, want {want}")
        check((mbconv.LAUNCHES, layout_pin.LAUNCHES) == (want[0] * runs, want[1] * runs),
              f"{route}: K6/K11 launches {mbconv.LAUNCHES}/{layout_pin.LAUNCHES} in the main path")
        check(wa.LAUNCHES == 10 * runs, f"{route}: K1 launches {wa.LAUNCHES}")
        check(logits[route].shape == (BATCH, 1000) and bool(torch.isfinite(logits[route]).all()),
              f"{route}: logits not finite")
        k6, k11 = k6 + mbconv.LAUNCHES, k11 + layout_pin.LAUNCHES
    # the host and the card share the pace; each route is timed 4 times in
    # interleaved rounds and the medians compared
    for order in (TV_ROUTES[::-1], TV_ROUTES, TV_ROUTES[::-1]):
        for route in order:
            set_tv_route(model, route)
            ips[route].append(throughput(model, BATCH, 224, dtype, iters, warmup))
    set_tv_route(model, "library")
    card = card_info()
    pin_same = torch.equal(logits["pin_layouts"], logits["library"]) and \
        torch.equal(logits["both"], logits["mbconv_kernel"])
    agree = (logits["mbconv_kernel"].argmax(-1) == logits["library"].argmax(-1)).float().mean().item()
    err = (logits["mbconv_kernel"] - logits["library"]).abs().max().item()
    print(f"main tiny_vit_21m_224 bf16 B={BATCH} routes: K6 launches per forward 2 "
          f"(mbconv_kernel, both), K11 3 (pin_layouts, both); pin_layouts logits bit-identical "
          f"to library (and both to mbconv_kernel): {pin_same}; mbconv_kernel vs library top-1 "
          f"agreement {agree:.4f} (need >= 0.99), logits max_abs_err={err:.3e} (not checked: "
          f"BN folded into bf16 weights rounds at other points)")
    check(pin_same, "pin_layouts changed the logits")
    check(agree >= 0.99, f"mbconv_kernel top-1 agreement {agree} < 0.99")
    median = {r: statistics.median(v) for r, v in ips.items()}
    print(f"main throughput tiny_vit_21m_224 bf16 B={BATCH} (rounds in the orders "
          f"{', '.join(TV_ROUTES)} / reversed / forward / reversed): " + "; ".join(
              f"{r} {' / '.join(f'{v:.1f}' for v in ips[r])} img/s (median {median[r]:.1f})"
              for r in TV_ROUTES) + f"; highest median: {max(median, key=median.get)} [{card}]")

    # fp32 golden with both routes on
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = np.load(GOLDEN)
    xg = np.random.default_rng(int(g["input_seed"])).standard_normal(
        (2, 224, 224, 3)).astype(np.float32)
    m = create_model("tiny_vit_21m_224", device="cuda", dtype=torch.float32,
                     mbconv_kernel=True, pin_layouts=True)
    m.load_state_dict(seeded_state_dict(m, int(g["weight_seed"])))
    mbconv.LAUNCHES = layout_pin.LAUNCHES = 0
    out = predict(m, torch.from_numpy(xg)).cpu().numpy()
    gerr = float(np.abs(out - g["logits"]).max())
    print(f"golden tiny_vit_21m_224 fp32 B=2 mbconv_kernel + pin_layouts vs JAX logits: "
          f"max_abs_err={gerr:.3e} bound=1.0e-03 (K6/K11 launches "
          f"{mbconv.LAUNCHES}/{layout_pin.LAUNCHES})")
    check((mbconv.LAUNCHES, layout_pin.LAUNCHES) == (2, 3), "golden: K6/K11 launches")
    check(bool(np.isfinite(out).all()) and gerr <= 1e-3, f"golden (K6, K11) err {gerr}")
    return k6, k11


def phase_tv384() -> int:
    """TinyViT-21M-384 bf16 bs64 eval: stage 2's single 24x24 window takes
    forward_windowed, whose partition and reverse run through K10. Returns
    the K10 launches of the main-path run."""
    dtype, batch = torch.bfloat16, 64
    gen = torch.Generator("cuda").manual_seed(5)
    model = create_model("tiny_vit_21m_384", device="cuda", dtype=dtype)
    model.load_state_dict(seeded_state_dict(model, 0))
    x = smooth_images(gen, batch, size=384).to(dtype)
    warmup, iters = 3, 10
    runs = 1 + warmup + iters
    window_relayout.LAUNCHES = wa.LAUNCHES = 0
    logits = predict(model, x)
    per = window_relayout.LAUNCHES
    ips = [throughput(model, batch, 384, dtype, iters, warmup)]
    launches = window_relayout.LAUNCHES
    check(per == 12, f"tiny_vit_21m_384: {per} K10 launches per forward, want 12")
    check(launches == 12 * runs, f"tiny_vit_21m_384: {launches} K10 launches in the main path")
    check(wa.LAUNCHES == 4 * runs, f"tiny_vit_21m_384: {wa.LAUNCHES} K1 launches (stages 1, 3)")
    check(logits.shape == (batch, 1000) and bool(torch.isfinite(logits).all()),
          "tiny_vit_21m_384 logits not finite")
    # the same forward with K10's two functions swapped for their plain
    # versions (K1 stays on in stages 1 and 3)
    kernels = (window_relayout.window_partition_kernel, window_relayout.window_reverse_kernel)
    window_relayout.window_partition_kernel = window_relayout.window_partition_ref
    window_relayout.window_reverse_kernel = window_relayout.window_reverse_ref
    try:
        swapped = predict(model, x)
        ips_swapped = [throughput(model, batch, 384, dtype, iters, warmup)]
    finally:
        window_relayout.window_partition_kernel, window_relayout.window_reverse_kernel = kernels
    check(window_relayout.LAUNCHES == launches, "the swapped forward launched K10")
    ips.append(throughput(model, batch, 384, dtype, iters, warmup))
    set_kernel(model, False)
    plain = predict(model, x)
    ips_plain = throughput(model, batch, 384, dtype, iters, warmup)
    set_kernel(model, True)
    check(window_relayout.LAUNCHES == launches + 12 * (warmup + iters),
          "the all-plain model launched K10, or the K10 route did not")
    same = torch.equal(logits, swapped)
    agree = (logits.argmax(-1) == plain.argmax(-1)).float().mean().item()
    print(f"main tiny_vit_21m_384 bf16 B={batch}: K10 launches per forward {per} (6 partitions "
          f"+ 6 reverses), K1 4; logits bit-identical to K10 swapped for its plain versions: "
          f"{same}; top-1 agreement with the all-plain model {agree:.4f} (need >= 0.99), "
          f"logits max_abs_err {(logits - plain).abs().max().item():.3e}")
    print(f"main throughput tiny_vit_21m_384 bf16 B={batch} (order K10, swapped, K10, "
          f"all-plain): K10 route {ips[0]:.1f} / {ips[1]:.1f} img/s, K10 swapped for plain "
          f"{ips_swapped[0]:.1f} img/s, all-plain {ips_plain:.1f} img/s [{card_info()}]")
    check(same, "K10 route logits differ from the plain relayout's")
    check(agree >= 0.99, f"tiny_vit_21m_384 top-1 agreement {agree} < 0.99")
    return launches


def phase_pin_train() -> int:
    """One TinyViT-21M-224 bf16 bs256 train step with pin_layouts on,
    against two unpinned ones from the same weights, batch and generator;
    deterministic algorithms on, so that run-to-run differences are what
    the library leaves. Returns the K11 launches."""
    dtype = torch.bfloat16
    gen = torch.Generator("cuda").manual_seed(6)
    base = create_model("tiny_vit_21m_224", device="cuda", dtype=dtype)
    sd = seeded_state_dict(base, 0)
    x = smooth_images(gen, BATCH).to(dtype)
    labels = torch.randint(0, 1000, (BATCH,), generator=gen, device="cuda")
    batch = {"image": x, "label": F.one_hot(labels, 1000).float()}
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    results = {}
    try:
        for key, pin in (("a", False), ("b", False), ("pinned", True)):
            m = create_model("tiny_vit_21m_224", device="cuda", dtype=dtype,
                             pin_layouts=pin).train()
            m.load_state_dict(sd)
            layout_pin.LAUNCHES = 0
            loss, _, grads = loss_and_grads(m, batch, soft_target_ce,
                                            step_generator(0, 0, "cuda"))
            torch.cuda.synchronize()
            results[key] = (float(loss), grads, layout_pin.LAUNCHES)
            del m
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    (la, ga, _), (lb, gb, _), (lp, gp, launches) = (results[k] for k in ("a", "b", "pinned"))
    check(launches == 3, f"pinned train step: {launches} K11 launches, want 3")
    d_run = {n: (gb[n] - ga[n]).abs().max().item() for n in ga}
    d_pin = {n: (gp[n] - ga[n]).abs().max().item() for n in ga}
    worse = [n for n in ga if d_pin[n] > d_run[n]]
    print(f"train tiny_vit_21m_224 bf16 B={BATCH} pin_layouts: K11 launches {launches} (3 in the "
          f"forward, none in the backward); loss {lp!r} vs unpinned {la!r} / {lb!r} "
          f"(bit-identical: {lp == la}); per-tensor max |grad diff| vs the first unpinned step: "
          f"pinned {max(d_pin.values()):.3e}, second unpinned {max(d_run.values()):.3e} "
          f"(largest), tensors where pinned differs more: {len(worse)} of {len(ga)}; "
          f"tensors bit-identical: pinned {sum(v == 0 for v in d_pin.values())}, second "
          f"unpinned {sum(v == 0 for v in d_run.values())}")
    check(lp == la, f"pinned loss {lp} != unpinned {la}")
    check(not worse, f"pinned grads differ more than two unpinned steps: {worse[:5]}")
    return launches


# ---- TinyCLIP's serving path (no TPU kernel lies on it) ----

CLIP_GOLDENS = ("tinyclip_vit_39m_16_text_19m", "clip_resnet50")
CLIP_PAIRS = (("tinyclip_vit_39m_16_text_19m", 256), ("clip_resnet50", 256))
CLIP_TEACHER_BATCH = 256
CLIP_GATES = ("hidden_z", "heads_z", "mha_z", "intermediate_z", "ffn_z")


def clip_gates(g, tower: str) -> dict:
    """The `tower` ("vision" or "text") gate set stored in a CLIP golden."""
    return {k: g[f"{tower}_{k}"] for k in CLIP_GATES}


def clip_hard_prune(sd: dict, vision: dict, text: dict, head_dim: int = 64) -> dict:
    """A CLIP state_dict (open_clip names) with 0/1 gates materialized by
    `models.clip.prune_clip_state_dict` (the state_dict half of
    `prune_clip`), as auto-weight-inheritance leaves a pruned checkpoint:
    gated-off hidden channels, heads and MLP channels removed, and a branch
    whose gate is 0 (or whose heads or channels are all off) removed with
    its LayerNorm. The ragged model `zoo.load.load_pruned_clip` builds from
    it computes what the gated model does."""
    return prune_clip_state_dict(sd, vision, text, head_dim)


def clip_golden_images(seed: int, batch: int = 2, size: int = 224) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((batch, size, size, 3)).astype(np.float32)


def phase_clip_golden(name: str) -> None:
    """The fp32 pair (B=2, TF32 off) of `name` on seeded weights against the
    JAX package's image features, text features and logit scale stored in
    tests/data/torch_port/ (1e-4: unit-norm features). For the ViT CLIP
    also the pair with a 0/1 gate set on both towers (hidden channels,
    heads, MLP channels and whole branches off), and the ragged model
    `zoo.load.load_pruned_clip` builds from the gated state_dict pruned, both
    against the JAX gated features."""
    from cream_tpu_torch.zoo.load import load_pruned_clip
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = np.load(DATA / f"{name}_seed0.npz")
    model = create_model(name, device="cuda")
    sd = seeded_state_dict(model, int(g["weight_seed"]))
    model.load_state_dict(sd)
    images = torch.from_numpy(clip_golden_images(int(g["input_seed"]))).cuda()
    text = torch.from_numpy(g["text"]).cuda()

    def err(feats, prefix: str = "") -> float:
        return max(float((f.cpu() - torch.from_numpy(g[f"{prefix}{k}"])).abs().max())
                   for f, k in zip(feats, ("image_features", "text_features")))

    with torch.inference_mode():
        img, txt, scale = model(images, text)
        e = err((img, txt))
        e_scale = abs(float(scale) - float(g["logit_scale"]))
        line = (f"CLIP golden {name} fp32 B=2: image/text features max err {e:.2e}, "
                f"logit scale err {e_scale:.2e} (bound 1e-4)")
        check(e <= 1e-4 and e_scale <= 1e-4 * float(g["logit_scale"]),
              f"{name} fp32 features err {e}, scale err {e_scale}")
        if "gated_image_features" in g:
            vm, tm = clip_gates(g, "vision"), clip_gates(g, "text")
            on_card = [{k: torch.from_numpy(v).cuda() for k, v in m.items()} for m in (vm, tm)]
            e_gated = err(model(images, text, *on_card)[:2], "gated_")
            ragged, rsd = load_pruned_clip(name, clip_hard_prune(sd, vm, tm), device="cuda")
            ragged.load_state_dict(rsd)
            e_ragged = err(ragged(images, text)[:2], "gated_")
            widths = (ragged.cfg.vision_width, ragged.cfg.text_width)
            heads = [b.attn.heads if hasattr(b, "attn") else 0
                     for b in ragged.visual.transformer.resblocks]
            line += (f"; gated pair err {e_gated:.2e}; ragged model from the pruned "
                     f"state_dict (hidden widths {widths}, vision heads/layer {heads}) err "
                     f"{e_ragged:.2e}")
            check(e_gated <= 1e-4 and e_ragged <= 1e-4,
                  f"{name} gated err {e_gated}, ragged err {e_ragged}")
    print(line)


def row_cosine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return F.cosine_similarity(a.float(), b.float(), dim=-1)


def phase_clip_pairs(name: str, batch: int) -> dict:
    """The pair main path of `name` at bf16 `batch`: pairs/s through
    cli.speed_test.pair_throughput (both towers consumed), peak memory, the
    device time by kind of op from cli.profile_step.profile; the bf16
    features against an fp32 copy of the model on the same inputs (cosine
    >= 0.999 a row) and each image's best text over the batch against
    fp32's on rows whose fp32 top-2 margin is above 4 bf16 ulps."""
    from cream_tpu_torch.cli.profile_step import profile
    from cream_tpu_torch.cli.speed_test import pair_inputs, pair_step, pair_throughput
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = create_model(name, device="cuda", dtype=torch.bfloat16)
    sd = seeded_state_dict(model, 0)
    model.load_state_dict(sd)
    pps = pair_throughput(model, batch, torch.bfloat16, 20, 3)
    images, text = pair_inputs(model, batch, torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        img16, txt16, _ = model(images, text)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30

        def fn():
            with torch.inference_mode():
                pair_step(model, images, text)

        prof = profile(fn, steps=3, warmup=2, top=8)
        ref = create_model(name, device="cuda", dtype=torch.float32)
        ref.load_state_dict(sd)
        img32, txt32, _ = ref(images.float(), text)
    del ref
    cos = torch.cat([row_cosine(img16, img32), row_cosine(txt16, txt32)])
    agree, decided, agree_decided = top1_agreement(img16.float() @ txt16.float().T,
                                                   img32 @ txt32.T)
    kinds = ", ".join(f"{k} {v:.2f}" for k, v in list(prof["by_kind_ms"].items())[:6])
    print(f"main {name} bf16 pairs B={batch}: {pps:.1f} pairs/s (both towers, CUDA events, "
          f"20 pair forwards after 3), peak memory {peak:.2f} GiB; profile: wall "
          f"{prof['wall_ms']:.2f} ms, device {prof['device_ms']:.2f} ms a pair forward, idle "
          f"share {prof['idle_share']:.3f}, {prof['launches']:.0f} launches; device ms by kind: "
          f"{kinds}; bf16 vs fp32 features: min row cosine {float(cos.min()):.5f} (bound "
          f"0.999); best text a row agrees on {agree:.4f} of rows, {agree_decided:.4f} of the "
          f"{decided:.4f} whose fp32 top-2 margin is above 4 bf16 ulps [{card_info()}]")
    check(float(cos.min()) >= 0.999, f"{name}: bf16 vs fp32 row cosine {float(cos.min())}")
    check(agree_decided == 1.0, f"{name}: best-text disagreement on decided rows")
    return {"pairs_per_s": pps, "peak_gib": peak, "device_ms": prof["device_ms"],
            "wall_ms": prof["wall_ms"], "idle_share": prof["idle_share"],
            "by_kind_ms": prof["by_kind_ms"]}


def phase_zero_shot() -> dict:
    """cli.zero_shot end to end, in bf16 and in fp32: TinyCLIP-ViT-39M/16
    on seeded weights, OpenAI's 1,000 ImageNet class names x 80 templates
    (80,000 prompts), a merges file learned from those names and templates
    (the released one is not in the repository), 1,024 synthetic images in
    bs256 batches with CLIP normalization. Each classifier column has unit
    norm, and the bf16 classifier agrees with the fp32 one (cosine >= 0.999
    a class). The accuracy of random weights on random images says only
    that the pipeline runs."""
    import tempfile

    from cream_tpu_torch.cli import zero_shot
    from cream_tpu_torch.data.tokenizer import learn_merges, write_merges
    from cream_tpu_torch.train.zero_shot import openai_imagenet_constants
    torch.backends.cuda.matmul.allow_tf32 = False
    names, templates = openai_imagenet_constants()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        bpe = Path(tmp) / "merges.txt.gz"
        t0 = time.perf_counter()
        write_merges(bpe, learn_merges(names + templates, 500))
        learn_s = time.perf_counter() - t0
        out = {}
        for dtype in ("bfloat16", "float32"):
            out[dtype] = zero_shot.main([
                "--bpe", str(bpe), "model.name=tinyclip_vit_39m_16_text_19m",
                f"model.dtype={dtype}", "data.dataset=synthetic", "data.batch_size=256"])
    c16, c32 = (out[k]["classifier"].float() for k in ("bfloat16", "float32"))
    norms16, norms32 = (torch.linalg.vector_norm(c, dim=0) for c in (c16, c32))
    cos = F.cosine_similarity(c16, c32, dim=0)
    r = out["bfloat16"]
    print(f"zero-shot tinyclip_vit_39m_16_text_19m: {c16.shape[1]} classes x {len(templates)} "
          f"templates; merges learned in {learn_s:.2f} s; bf16: tokenizer {r['tokenize_s']:.3f} "
          f"s (host), text passes {r['encode_s']:.3f} s, image passes {r['image_s']:.3f} s "
          f"({r['n']} images), top-1 {r['zeroshot_top1']:.3f} top-5 {r['zeroshot_top5']:.3f} "
          f"(random weights and images: a pipeline check); fp32 text passes "
          f"{out['float32']['encode_s']:.3f} s; column norms bf16 "
          f"{float((norms16 - 1).abs().max()):.2e} / fp32 {float((norms32 - 1).abs().max()):.2e} "
          f"from 1; bf16 vs fp32 classifier min cosine {float(cos.min()):.5f} (bound 0.999) "
          f"[{card_info()}]")
    check(float((norms32 - 1).abs().max()) <= 1e-5, "fp32 classifier columns not unit norm")
    check(float((norms16 - 1).abs().max()) <= 8e-3, "bf16 classifier columns not unit norm")
    check(float(cos.min()) >= 0.999, f"bf16 vs fp32 classifier cosine {float(cos.min())}")
    check(r["n"] == 1024 and out["float32"]["n"] == 1024, "zero-shot did not see 1,024 images")
    return r


def phase_clip_teacher() -> float:
    """cli.save_logits with the CLIP-ViT-L/14-22k teacher
    (clip_vit_large14_224_classifier, 21,841 classes, seeded weights) at
    bf16 bs256 over the synthetic set's 1,024 images, the seeded 1k -> 22k
    mapping of phase_distill, top-100; then --check. Returns the teacher's
    img/s."""
    import tempfile

    from cream_tpu_torch.cli import save_logits
    from cream_tpu_torch.distill import LogitsReader
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        tmp = Path(tmp)
        mapping = distill_mapping(tmp / "map.txt")
        argv = ["model.name=clip_vit_large14_224_classifier", "model.num_classes=21841",
                "model.dtype=bfloat16", "data.dataset=synthetic",
                f"data.batch_size={CLIP_TEACHER_BATCH}", "distill.logits_topk=100",
                "--allow-random", "--remap-1kto22k", str(tmp / "map.txt"),
                "--out", str(tmp / "store")]
        (saved,) = save_logits.main(argv)
        reader = LogitsReader(str(tmp / "store"), 0)
        vals, idxs, _ = reader.read_batch(np.arange(reader.num_samples))
        reader.close()
        med = {k: statistics.median(v[1:]) for k, v in saved["ms"].items()}
        ips = CLIP_TEACHER_BATCH / med["teacher"] * 1e3
        print(f"CLIP-L/14-22k teacher save_logits bf16 B={CLIP_TEACHER_BATCH}: "
              f"{len(saved['ms']['teacher'])} batches, {saved['records']} records; per batch "
              f"(median of batches 2-{len(saved['ms']['teacher'])}): teacher "
              f"{med['teacher']:.3f} ms = {ips:.1f} img/s (mixup, forward, remap, softmax), "
              f"host ms: upload {med['upload']:.3f}, top-K {med['topk']:.3f}, transfer "
              f"{med['transfer']:.3f}, pack_write {med['pack_write']:.3f}; whole pass "
              f"{saved['wall_ms'] / 1e3:.2f} s [{card_info()}]")
        check(saved["records"] == 4 * CLIP_TEACHER_BATCH, f"{saved['records']} records")
        check(not np.isin(idxs, np.flatnonzero(mapping < 0)).any(),
              "an absent 22k class was stored")
        check(bool((vals.sum(-1) <= 1 + 1e-3).all()), "a record's top-100 sums above 1")
        (checked,) = save_logits.main(argv + ["--check"])
        print(f"CLIP-L/14-22k save_logits --check: value max err "
              f"{checked['value_max_err']:.3e} (bound 1e-3: the fp16 store), index diff rate "
              f"{checked['index_diff_rate']:.4f} (JAX's metric, counts tie order), tie-aware "
              f"miss rate {checked['index_miss_rate']:.4f} (bound 0) over {checked['n']}")
        check(checked["value_max_err"] <= 1e-3, f"--check value error {checked['value_max_err']}")
        check(checked["index_miss_rate"] == 0.0, f"--check miss rate {checked['index_miss_rate']}")
    return ips


# ---- TinyCLIP's training path (no TPU kernel lies on it) ----

TINYCLIP = "tinyclip_vit_39m_16_text_19m"
CLIP_TRAIN_GOLDEN = DATA / "tinyclip_39m_train_seed0.npz"
CLIP_TRAIN_BATCH = 256


def clip_train_golden_step(g, device) -> tuple[torch.Tensor, dict, dict]:
    """The L0 distillation step of TinyCLIP-39M/16 that the golden `g`
    stores (fp32, B=2, seeded weights, gates from its log-alpha, its
    uniforms for each tower's masks, its step of the sparsity warmup) on
    `device`: (loss, grads by param name, L0 grads by name)."""
    from cream_tpu_torch.cli.tinyclip_pipeline import L0Distill
    model = create_model(TINYCLIP, device=device)
    model.load_state_dict(seeded_state_dict(model, int(g["weight_seed"])))
    trainer = L0Distill(model, lr=1e-4, l0_lr=1e-2, target_sparsity=float(g["target"]),
                        sparsity_warmup=int(g["warmup"]),
                        l0_init_mean=float(g["l0_init_mean"]))
    trainer.steps = int(g["step"])
    images = torch.from_numpy(clip_golden_images(int(g["input_seed"]))).to(device)
    text = torch.from_numpy(g["text"]).to(device)
    uniforms = {k: {m: torch.from_numpy(g[f"u_{k}_{m}"]).to(device)
                    for m in CLIP_GATES if f"u_{k}_{m}" in g} for k in ("v", "t")}
    loss, _ = trainer.loss(images, text, uniforms=uniforms)
    params = dict(model.named_parameters())
    l0 = trainer.named_l0()
    grads = torch.autograd.grad(loss, [*params.values(), *l0.values()])
    return (loss.detach(), dict(zip(params, grads[:len(params)])),
            {k: v.cpu().numpy() for k, v in zip(l0, grads[len(params):])})


def l0_grad_errors(g, l0_grads: dict) -> dict:
    """Each L0 grad's max abs error against the golden's, over its largest
    magnitude."""
    return {k: float(np.abs(v - g[f"l0grad_{k}"]).max() / np.abs(g[f"l0grad_{k}"]).max())
            for k, v in l0_grads.items()}


def phase_clip_train_golden() -> None:
    """The fp32 B=2 L0 distillation step of TinyCLIP-39M/16 (TF32 off) on
    the card against the JAX golden stored by
    tests/test_torch_tinyclip_train.py: the loss and global grad norm
    (1e-4 relative), every per-tensor grad norm (1e-3), every L0 grad
    (1e-3 of its largest magnitude)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = np.load(CLIP_TRAIN_GOLDEN)
    loss, grads, l0_grads = clip_train_golden_step(g, "cuda")
    check_step_golden(f"TinyCLIP-39M/16 L0 distill golden (step {int(g['step'])})", g, loss,
                      grads)
    errs = l0_grad_errors(g, l0_grads)
    worst = max(errs, key=errs.get)
    print(f"TinyCLIP-39M/16 L0 distill golden: {len(errs)} L0 grads (loga, multipliers), "
          f"worst max-abs err over max magnitude {errs[worst]:.2e} ({worst}; bound 1e-3)")
    check(errs[worst] <= 1e-3, f"L0 grads vs the golden: {errs}")


def phase_clip_train(batch: int = CLIP_TRAIN_BATCH) -> dict:
    """The TinyCLIP-39M/16 training main path: its L0 distillation step at
    bf16 `batch` (fp32 params) through cli.speed_test.
    tinyclip_train_throughput, with remat off and on: pairs/s (CUDA events,
    10 steps after 3), peak memory; the first step's loss the same with
    remat within 2 bf16 ulps, and less memory with it; the device time by
    kind of op of the step without remat (cli.profile_step.profile)."""
    from cream_tpu_torch.cli.profile_step import profile
    from cream_tpu_torch.cli.speed_test import (tinyclip_train_step_fn,
                                                tinyclip_train_throughput)
    out = {}
    for remat in (False, True):
        model = create_model(TINYCLIP, device="cuda", dtype=torch.bfloat16, remat=remat)
        model.load_state_dict(seeded_state_dict(model, 0))
        out[remat] = tinyclip_train_throughput(model, batch, 10, 3)
        if not remat:
            _, fn = tinyclip_train_step_fn(model, batch)
            out["profile"] = profile(fn, steps=3, warmup=2, top=8)
        del model
        torch.cuda.empty_cache()
    off, on, prof = out[False], out[True], out["profile"]
    d_loss = abs(on["first_loss"] - off["first_loss"])
    ulp = float(bf16_ulp(torch.tensor(off["first_loss"])))
    kinds = ", ".join(f"{k} {v:.2f}" for k, v in list(prof["by_kind_ms"].items())[:8])
    print(f"main TinyCLIP-39M/16 L0 distill train bf16 B={batch} "
          f"(tinyclip_39m_train_throughput): {off['pairs_per_s']:.1f} pairs/s "
          f"({off['ms_per_step']:.2f} ms a step by CUDA events), peak memory "
          f"{off['peak_gib']:.2f} GiB; remat {on['pairs_per_s']:.1f} pairs/s "
          f"({on['ms_per_step']:.2f} ms), peak {on['peak_gib']:.2f} GiB; first loss "
          f"{off['first_loss']:.6f} / {on['first_loss']:.6f} (diff {d_loss:.2e}, bound 2 bf16 "
          f"ulps = {2 * ulp:.2e}); profile (no remat): wall {prof['wall_ms']:.2f} ms, device "
          f"{prof['device_ms']:.2f} ms a step, idle share {prof['idle_share']:.3f}, "
          f"{prof['launches']:.0f} launches; device ms by kind: {kinds} [{card_info()}]")
    check(d_loss <= 2 * ulp, f"remat changed the first loss by {d_loss}")
    check(on["peak_gib"] < off["peak_gib"], "remat did not lower the peak memory")
    return out


def phase_clip_train_steps(batch: int = CLIP_TRAIN_BATCH, steps: int = 20) -> dict:
    """`steps` L0 distillation steps of TinyCLIP-39M/16 bf16 on one `batch`
    batch (the step of phase_clip_train): the loss falls and both towers'
    expected sparsity rises toward the target. Then the fuse on the card:
    the trained student in fp32 (TF32 off) with its deterministic masks, a
    seeded quarter of each gate set's log-alphas first pushed to -10 so the
    fuse removes hidden channels, heads and MLP channels, against
    `prune_clip`'s ragged model on the same pairs: features within 1e-4;
    params before and after."""
    from cream_tpu_torch.cli.speed_test import pair_inputs, tinyclip_train_step_fn
    from cream_tpu_torch.distill.l0 import named_l0
    model = create_model(TINYCLIP, device="cuda", dtype=torch.bfloat16)
    model.load_state_dict(seeded_state_dict(model, 0))
    trainer, run = tinyclip_train_step_fn(model, batch)
    losses, sparsity = [], []
    for _ in range(steps):
        loss, s = run()
        losses.append(float(loss))
        sparsity.append({k: float(v) for k, v in s.items()})
    target = trainer.target_sparsity
    print(f"TinyCLIP-39M/16 L0 distill bf16 B={batch}, {steps} steps on one batch: loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; expected sparsity vision "
          f"{sparsity[0]['v']:.3e} -> {sparsity[-1]['v']:.3e}, text {sparsity[0]['t']:.3e} "
          f"-> {sparsity[-1]['t']:.3e} (target {target}, warmed up over "
          f"{trainer.sparsity_warmup} steps)")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    check(all(sparsity[0][k] < sparsity[-1][k] < target for k in ("v", "t")),
          f"the expected sparsity did not rise toward {target}: {sparsity}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for p in trainer.l0.values():
            for k, t in named_l0(p).items():
                if "loga" in k:
                    flat = t.view(-1)
                    flat[torch.from_numpy(rng.permutation(flat.numel())[:flat.numel() // 4])
                         .to(flat.device)] = -10.0
    masks = trainer.masks()
    full = create_model(TINYCLIP, device="cuda")
    sd = model.state_dict()
    full.load_state_dict(sd)
    pruned, pruned_sd = prune_clip(sd, full.cfg, masks["v"], masks["t"], device="cuda")
    images, text = pair_inputs(full, 64, torch.float32, seed=5)
    with torch.no_grad():
        want = full(images, text, masks["v"], masks["t"])
        got = pruned(images, text)
    err = max(float((a - b).abs().max()) for a, b in zip(got[:2], want[:2]))
    before, after = (sum(int(v.numel()) for v in d.values()) for d in (sd, pruned_sd))
    heads = [b.attn.heads if hasattr(b, "attn") else 0 for b in pruned.visual.transformer.resblocks]
    print(f"fuse on the card (prune_clip): params {before} -> {after} ({after / before:.2%}); "
          f"hidden widths {pruned.cfg.vision_width} / {pruned.cfg.text_width}, vision heads "
          f"a layer {heads}; pruned vs masked fp32 features (B=64) max err {err:.2e} "
          f"(bound 1e-4)")
    check(after < before and pruned.cfg.vision_width < full.cfg.vision_width
          and pruned.cfg.text_width < full.cfg.text_width, "the fuse removed nothing")
    check(err <= 1e-4, f"pruned vs masked features err {err}")
    return {"losses": losses, "sparsity": sparsity, "params": (before, after), "fuse_err": err}


def phase_clip_pipeline() -> list:
    """cli.tinyclip_pipeline.main on the card at the JAX package's smoke
    size (`--synthetic`, two stages 0.25 and 0.333, 30 steps of bs8, gates
    from log-alpha 2 at lr 0.5): each stage shrinks both towers, the final
    pair similarity is finite; its wall seconds."""
    import tempfile

    from cream_tpu_torch.cli import tinyclip_pipeline
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        t0 = time.perf_counter()
        report = tinyclip_pipeline.main([
            "--synthetic", "--sparsities", "0.25", "0.333", "--steps", "30",
            "--batch-size", "8", "--l0-lr", "0.5", "--l0-init-mean", "2.0", "--out", tmp])
        wall = time.perf_counter() - t0
    stages = [r for r in report if "params" in r]
    print(f"cli.tinyclip_pipeline on cuda (2 L0 stages, 30 steps each, bs8): params "
          f"{[r['params'] for r in stages]}, vision widths "
          f"{[r['vision_width'] for r in stages]}, text widths "
          f"{[r.get('text_width', 128) for r in stages]}, final pair similarity "
          f"{report[-1]['final_pair_similarity']:.4f}; {wall:.1f} s")
    for a, b in zip(stages, stages[1:]):
        check(b["params"] < a["params"] and b["vision_width"] < a["vision_width"]
              and b["text_width"] < a.get("text_width", 128), f"a stage did not shrink: {b}")
    return report


# DeiT with iRPE and Mini-DeiT (no TPU kernel lies on their path: the
# attention and the iRPE gather are plain tensor math), and Mini-Swin's
# distillation capture
DEIT_S_K = "deit_small_patch16_224_ctx_product_50_shared_k"
MINI_DEIT_S = "mini_deit_small_patch16_224"
DEIT_GOLDENS = (DEIT_S_K, "deit_tiny_patch16_224_ctx_product_50_shared_qkv", MINI_DEIT_S)
DEIT_TRAIN_GOLDEN = DATA / "deit_small_rpe_k_train_seed0.npz"
DEIT_BATCH = 256
# the PERF.md metric stem of each main-path model
DEIT_METRICS = {DEIT_S_K: "deit_small_rpe_k_224", MINI_DEIT_S: "mini_deit_small_224"}


def no_tf32() -> None:
    """fp32 products in fp32: the goldens and the fp32 references hold no
    TF32 rounding."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def kernel_counts() -> tuple:
    """Every kernel wrapper's launch count (K1-K11)."""
    return (wa.LAUNCHES, wa.BWD_LAUNCHES, bias_attention.LAUNCHES, cga.LAUNCHES,
            cga_core.LAUNCHES, mbconv.LAUNCHES, tuple(dwconv.LAUNCHES.values()),
            window_relayout.LAUNCHES, layout_pin.LAUNCHES)


def phase_deit_goldens() -> None:
    """The fp32 B=2 logits (TF32 off) of DeiT-S iRPE-K, DeiT-Ti iRPE-QKV and
    Mini-DeiT-S on seeded weights against the JAX goldens (1e-3), and one
    fp32 B=2 DeiT-S iRPE-K train step (drop path 0) against the JAX train
    golden: loss and grad norm 1e-4, per-tensor grad norms 1e-3, the 12
    rpe_k tables' grads within 1e-3 of their largest magnitude (the gather's
    backward adds with atomics on the card)."""
    no_tf32()
    for name in DEIT_GOLDENS:
        phase_golden(name, DATA / f"{name}_seed0.npz")
    g = np.load(DEIT_TRAIN_GOLDEN)
    rng = np.random.default_rng(int(g["input_seed"]))
    x = rng.standard_normal((2, 224, 224, 3)).astype(np.float32)
    y = np.eye(1000, dtype=np.float32)[rng.integers(0, 1000, 2)]
    m = create_model(DEIT_S_K, device="cuda")
    m.load_state_dict(seeded_state_dict(m, int(g["weight_seed"])))
    loss, _, grads = loss_and_grads(m, {"image": torch.from_numpy(x).cuda(),
                                        "label": torch.from_numpy(y).cuda()}, soft_target_ce)
    check_step_golden("train golden DeiT-S iRPE-K", g, loss, grads)
    tables = torch.stack([grads[f"blocks.{i}.attn.rpe_k.lookup_table_weight"]
                          for i in range(12)]).cpu().numpy()
    err = float(np.abs(tables - g["table_grads"]).max() / np.abs(g["table_grads"]).max())
    print(f"train golden DeiT-S iRPE-K: the 12 rpe_k tables' grads (gather backward, a "
          f"scatter-add) max err / max |grad| {err:.2e} (bound 1e-3)")
    check(err <= 1e-3, f"rpe_k table grads err {err}")


def phase_deit_eval(name: str, batch: int = DEIT_BATCH) -> dict:
    """An iRPE eval main path at bf16 `batch`: img/s through
    cli.speed_test.throughput (CUDA events, 20 forwards after 3), peak
    memory of a predict, device time by kind of op (cli.profile_step.profile);
    bf16 top-1 against an fp32 copy (TF32 off) on 512 low-frequency images,
    counted on those whose fp32 top-2 margin is above 4 bf16 ulps (need >=
    0.99 on >= 100)."""
    from cream_tpu_torch.cli.profile_step import profile
    no_tf32()
    dtype = torch.bfloat16
    gen = torch.Generator("cuda").manual_seed(3)
    model = create_model(name, device="cuda", dtype=dtype)
    sd = seeded_state_dict(model, 0)
    model.load_state_dict(sd)
    ips = throughput(model, batch, 224, dtype, 20, 3)
    images = [smooth_images(gen, batch) for _ in range(512 // batch)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    logits = torch.cat([predict(model, x) for x in images])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    x16 = images[0].to(dtype)

    def fn():
        with torch.inference_mode():
            model(x16)

    prof = profile(fn, steps=3, warmup=2, top=8)
    ref = create_model(name, device="cuda")
    ref.load_state_dict(sd)
    want = torch.cat([predict(ref, x) for x in images])
    del ref
    agree, decided, agree_decided = top1_agreement(logits, want)
    n_decided = round(decided * len(want))
    kinds = ", ".join(f"{k} {v:.2f}" for k, v in list(prof["by_kind_ms"].items())[:8])
    print(f"main {name} bf16 B={batch} ({DEIT_METRICS[name]}_infer_throughput): {ips:.1f} img/s "
          f"(CUDA events, 20 forwards after 3), peak memory {peak:.2f} GiB; profile: wall "
          f"{prof['wall_ms']:.2f} ms, device {prof['device_ms']:.2f} ms a forward, idle share "
          f"{prof['idle_share']:.3f}, {prof['launches']:.0f} launches; device ms by kind: "
          f"{kinds}; bf16 vs fp32 top-1 {agree:.4f} over {len(want)} images, {agree_decided:.4f} "
          f"on the {n_decided} whose fp32 top-2 margin is above 4 bf16 ulps (need >= 0.99 on "
          f">= 100) [{card_info()}]")
    check(logits.shape == (len(want), 1000) and bool(torch.isfinite(logits).all()),
          f"{name}: bf16 logits not finite")
    check(n_decided >= 100 and agree_decided >= 0.99,
          f"{name}: bf16 vs fp32 top-1 {agree_decided} on {n_decided} decided images")
    return {"img_per_s": ips, "peak_gib": peak, **{k: prof[k] for k in (
        "wall_ms", "device_ms", "idle_share", "launches", "by_kind_ms", "top_kernels_ms")}}


def phase_deit_train(name: str, batch: int = DEIT_BATCH, steps: int = 20) -> dict:
    """An iRPE train main path at bf16 `batch` (fp32 params), drop path 0.1
    (DeiT's --drop-path): `steps` steps of train.make_train_step (AdamW 1e-3,
    wd 0.05, clip 5) on one batch, the loss falls; train img/s through
    cli.speed_test.train_throughput (the step of `bench.py:407-466`, CUDA
    events over 10 steps after 3) with the peak memory over them; device
    time by kind of op of that step (cli.profile_step.profile): the gather
    and its scatter-add backward by name."""
    from cream_tpu_torch.cli.profile_step import profile
    from cream_tpu_torch.cli.speed_test import train_step_fn
    dtype = torch.bfloat16
    gen = torch.Generator("cuda").manual_seed(4)
    model = create_model(name, device="cuda", dtype=dtype, drop_path_rate=0.1)
    model.load_state_dict(seeded_state_dict(model, 0))
    x = smooth_images(gen, batch).to(dtype)
    labels = torch.randint(0, 1000, (batch,), generator=gen, device="cuda")
    state = TrainState(model, make_adamw(1e-3, weight_decay=0.05, clip_grad=5.0,
                                         params=dict(model.named_parameters())))
    step = make_train_step(loss_fn=soft_target_ce)
    data = {"image": x, "label": F.one_hot(labels, 1000).float()}
    losses = [float(step(state, data, 0)[1]["loss"]) for _ in range(steps)]
    del state
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ips = train_throughput(model, batch, 224, dtype, 10, 3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    prof = profile(train_step_fn(model, batch, 224, dtype), steps=3, warmup=2, top=8)
    kinds = ", ".join(f"{k} {v:.2f}" for k, v in list(prof["by_kind_ms"].items())[:10])
    print(f"train {name} bf16 B={batch}, drop path 0.1: loss over {steps} steps on one batch "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; ({DEIT_METRICS[name]}_train_throughput) "
          f"{ips:.1f} img/s (CUDA events, 10 steps after 3), peak memory {peak:.2f} GiB; "
          f"profile: wall {prof['wall_ms']:.2f} ms, device {prof['device_ms']:.2f} ms a step, "
          f"idle share {prof['idle_share']:.3f}, {prof['launches']:.0f} launches; device ms by "
          f"kind: {kinds} [{card_info()}]")
    check(all(np.isfinite(losses)), f"{name}: train loss not finite: {losses}")
    check(losses[-1] < losses[0], f"{name}: train loss did not fall: {losses}")
    return {"img_per_s": ips, "peak_gib": peak, "losses": losses, **{k: prof[k] for k in (
        "wall_ms", "device_ms", "idle_share", "launches", "by_kind_ms", "top_kernels_ms")}}


def phase_mini_swin_capture(batch: int = S3T_BATCH) -> dict:
    """Mini-Swin-T bf16 `batch` forward with capture_distill (MiniViT's
    distillation states): the logits bit for bit those without capture,
    one qkv and one hidden state per executed layer; their count and
    shapes."""
    dtype = torch.bfloat16
    model = create_model("mini_swin_tiny", device="cuda", dtype=dtype)
    model.load_state_dict(seeded_state_dict(model, 0))
    x = smooth_images(torch.Generator("cuda").manual_seed(5), batch).to(dtype)
    plain = predict(model, x)
    model.capture_distill = True
    with torch.inference_mode():
        logits, captures = model(x)
    model.capture_distill = False
    shapes: dict = {}
    for key in ("qkv_states", "hidden"):
        for t in captures[key]:
            shapes[(key, tuple(t.shape))] = shapes.get((key, tuple(t.shape)), 0) + 1
    same = torch.equal(logits.float(), plain)
    print(f"Mini-Swin-T bf16 B={batch} with capture_distill: logits bit-identical to the "
          f"forward without capture: {same}; {len(captures['qkv_states'])} qkv states, "
          f"{len(captures['hidden'])} hidden states: "
          + ", ".join(f"{k} {list(s)} x{n}" for (k, s), n in shapes.items()))
    check(same, "capture_distill changed the logits")
    check(len(captures["qkv_states"]) == len(captures["hidden"]) == 12,
          "capture: one qkv and one hidden state per executed layer (12)")
    check(all(bool(torch.isfinite(t).all()) for v in captures.values() for t in v),
          "capture: non-finite states")
    return {"count": len(captures["qkv_states"]), "shapes": shapes}


# One-shot NAS: AutoFormer's supernet, its training and
# evolution search (no TPU kernel: JAX's attention is plain jnp), and
# Cream's supernet and childnets, whose depthwise 3x3 sites reach K7/K9 on
# "fused"
AF = "autoformer_supernet_tiny"
AF_GOLDEN = DATA / "autoformer_supernet_tiny_seed0.npz"
AF_TRAIN_GOLDEN = DATA / "autoformer_supernet_tiny_train_seed0.npz"
AF_BATCH, EVO_BATCH, CREAM_BATCH = 128, 256, 128
# Cream's 19 depthwise 3x3 site shapes at the supernet step's batch, held
# to the plain versions in `phase_dw` (checked, not timed)
DW_CREAM = [(f"cream_{i}", *shape, stride, 0)
            for i, (stride, shape) in enumerate(dw3x3_sites(batch=CREAM_BATCH))]


def af_inactive_grads_zero(config: dict, grads: dict) -> bool:
    """Whether every grad outside `config`'s slices of the super weights is
    exactly 0 (the embed columns past its width, the qkv / fc rows past its
    heads and MLP widths, the blocks past its depth)."""
    from cream_tpu_torch.models.autoformer import HEAD_DIM, ffn_dims
    emb, depth = config["embed_dim"][0], config["layer_num"]
    zero = [grads["cls_token"][..., emb:], grads["pos_embed"][..., emb:],
            grads["patch_embed_super.proj.weight"][emb:], grads["head.weight"][:, emb:],
            grads["norm.weight"][emb:]]
    for i, (heads, ffn) in enumerate(zip(config["num_heads"], ffn_dims(config))):
        p, qd = f"blocks.{i}", heads * HEAD_DIM
        zero += [grads[f"{p}.attn.qkv.weight"][3 * qd:], grads[f"{p}.attn.qkv.weight"][:, emb:],
                 grads[f"{p}.attn.proj.weight"][emb:], grads[f"{p}.attn.proj.weight"][:, qd:],
                 grads[f"{p}.fc1.weight"][ffn:], grads[f"{p}.fc2.weight"][:, ffn:]]
    zero += [g for k, g in grads.items() if k.startswith("blocks.")
             and int(k.split(".")[1]) >= depth]
    return all(not bool(t.any()) for t in zero)


def phase_autoformer_goldens() -> None:
    """9q. autoformer_supernet_tiny fp32 B=2 (TF32 off) at the smallest,
    largest and a sampled config against the JAX package's logits (1e-3);
    `extract_subnet`'s logits against the supernet's at each (1e-5 of the
    largest |logit|); one fp32 B=2 supernet train step (drop path 0) at a
    sampled config against the JAX loss and per-tensor grad norms
    (`check_step_golden`: 1e-4, 1e-3), every grad outside the config's
    slices exactly 0."""
    from cream_tpu_torch.models.autoformer import extract_subnet, fixed_config
    no_tf32()
    g = np.load(AF_GOLDEN)
    x = torch.from_numpy(np.random.default_rng(int(g["input_seed"])).standard_normal(
        (2, 224, 224, 3)).astype(np.float32)).cuda()
    m = create_model(AF, device="cuda")
    m.load_state_dict(seeded_state_dict(m, int(g["weight_seed"])))
    for spec in ("smallest", "largest", "seed:1"):
        config = fixed_config(m.space, spec)
        check(json.loads(str(g[f"config_{spec}"])) == config, f"golden config {spec}")
        with torch.no_grad():
            logits = m(x, config=config)
            sub = extract_subnet(m, config)(x)
        err = float(np.abs(logits.cpu().numpy() - g[f"logits_{spec}"]).max())
        sub_err = float((sub - logits).abs().max() / logits.abs().max())
        print(f"golden {AF} fp32 B=2 at {spec} (depth {config['layer_num']}, embed "
              f"{config['embed_dim'][0]}) vs JAX logits: max_abs_err={err:.3e} bound=1e-3; "
              f"extract_subnet vs the supernet: {sub_err:.2e} of the largest |logit| "
              f"(bound 1e-5) [{card_info()}]")
        check(bool(torch.isfinite(logits).all()) and err <= 1e-3, f"{AF} golden {spec}: {err}")
        check(sub_err <= 1e-5, f"{AF} subnet at {spec}: {sub_err}")
    g = np.load(AF_TRAIN_GOLDEN)
    rng = np.random.default_rng(int(g["input_seed"]) + 1)
    x = torch.from_numpy(rng.standard_normal((2, 224, 224, 3)).astype(np.float32)).cuda()
    y = torch.from_numpy(rng.integers(0, 1000, 2)).cuda()
    m = create_model(AF, device="cuda", drop_path_rate=0.0)
    m.load_state_dict(seeded_state_dict(m, int(g["weight_seed"])))
    config = json.loads(str(g["config"]))
    m.train()
    loss = F.cross_entropy(m(x, config=config), y)
    params = dict(m.named_parameters())
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()),
                                                 materialize_grads=True)))
    check_step_golden(f"train golden {AF} (depth {config['layer_num']})", g, loss.detach(),
                      grads)
    check(af_inactive_grads_zero(config, grads), f"{AF}: a grad outside the config is not 0")
    print(f"train golden {AF}: every grad outside the config's slices exactly 0 "
          f"[{card_info()}]")


def timed_steps(run, n: int) -> list[float]:
    """ms of each of `n` calls of `run`, CUDA events around each."""
    out = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def phase_autoformer_train() -> tuple[str, dict]:
    """9r. AutoFormer-T supernet training, bf16 compute, fp32 params, bs128
    at 224: `cli.supernet_train.main` runs one epoch (4 steps of synthetic
    data) into a directory under build/ (its checkpoint feeds 9s); then
    `make_supernet_train_step` (AdamW 1e-3, wd 0.05, clip 5, drop path 0.1)
    for 3 warmup and 10 timed steps at configs drawn by default_rng(0), img/s
    per step (median, min, max), the largest config's img/s (5 steps after
    2) and the peak memory over the timed steps; 20 steps on one batch at
    the largest config, the loss falls; no module or parameter storage of
    the one supernet object changes across the configs. Returns (the
    checkpoint directory, numbers)."""
    from cream_tpu_torch.cli import supernet_train
    from cream_tpu_torch.models.autoformer import fixed_config, sample_config
    from cream_tpu_torch.nas.supernet_engine import make_supernet_train_step
    out_dir = ROOT / "build" / "chip_smoke_nas"
    import shutil
    shutil.rmtree(out_dir, ignore_errors=True)
    t0 = time.perf_counter()
    ckpt = supernet_train.main(["--space", "tiny", "data.dataset=synthetic",
                                f"data.batch_size={AF_BATCH}", "train.epochs=1",
                                "train.warmup_epochs=0", f"output={out_dir}"])
    cli_s = time.perf_counter() - t0
    dtype = torch.bfloat16
    gen = torch.Generator("cuda").manual_seed(8)
    m = create_model(AF, device="cuda", dtype=dtype)
    m.load_state_dict(seeded_state_dict(m, 0))
    modules = [id(mod) for mod in m.modules()]
    storages = {n: p.data_ptr() for n, p in m.named_parameters()}
    state = TrainState(m, make_adamw(1e-3, weight_decay=0.05, clip_grad=5.0,
                                     params=dict(m.named_parameters())))
    step = make_supernet_train_step()
    batch = {"image": smooth_images(gen, AF_BATCH).to(dtype),
             "label": torch.randint(0, 1000, (AF_BATCH,), generator=gen, device="cuda")}
    rng = np.random.default_rng(0)
    configs = [sample_config(rng, m.space) for _ in range(13)]
    for c in configs[:3]:
        step(state, batch, c)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    it = iter(configs[3:])
    ms = timed_steps(lambda: step(state, batch, next(it)), 10)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ips = [AF_BATCH / t * 1e3 for t in ms]
    largest = fixed_config(m.space, "largest")
    for _ in range(2):
        step(state, batch, largest)
    ips_largest = AF_BATCH / statistics.median(
        timed_steps(lambda: step(state, batch, largest), 5)) * 1e3
    losses = [float(step(state, batch, largest)[1]["loss"]) for _ in range(20)]
    same = ([id(mod) for mod in m.modules()] == modules
            and {n: p.data_ptr() for n, p in m.named_parameters()} == storages)
    print(f"cli.supernet_train --space tiny bf16 bs{AF_BATCH}, 1 epoch of 4 steps: "
          f"{cli_s:.1f} s, checkpoint {Path(ckpt).relative_to(ROOT)} [{card_info()}]")
    print(f"train {AF} bf16 B={AF_BATCH} (autoformer_t_supernet_train_throughput), a sampled "
          f"config a step (depths {[c['layer_num'] for c in configs[3:]]}): median "
          f"{statistics.median(ips):.1f} img/s (min {min(ips):.1f}, max {max(ips):.1f}; CUDA "
          f"events a step, 10 steps after 3), the largest config {ips_largest:.1f} img/s; "
          f"peak memory {peak:.2f} GiB; 20 steps on one batch at the largest config: loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; one model object and the same parameter "
          f"storages across the configs: {same} [{card_info()}]")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], f"{AF} loss did not fall: {losses}")
    check(same, f"{AF}: a module or parameter storage changed between configs")
    return ckpt, {"img_per_s_median": statistics.median(ips), "img_per_s_min": min(ips),
                  "img_per_s_max": max(ips), "img_per_s_largest": ips_largest,
                  "peak_gib": peak, "losses": losses}


def phase_evolution(ckpt: str) -> dict:
    """9s. BASELINE.json configs[3]: `cli.search_evolution.main` on 9r's
    checkpoint, 1,024 synthetic val images at bf16 bs256, the tiny space,
    population 16, 2 epochs, parameter window 5-6 M (around AutoFormer-T's
    5.7 M): candidates scored per second and eval img/s (the CLI's own
    clock around the search); the best config's `AutoFormerSubnet` bf16
    bs256 through `throughput`, and its top-1 against the supernet at that
    config on 512 low-frequency images (>= 99% on those whose top-2 margin
    is above 4 bf16 ulps)."""
    import contextlib
    import io
    import re

    from cream_tpu_torch.cli import search_evolution
    from cream_tpu_torch.core.checkpoint import restore_params
    from cream_tpu_torch.models.autoformer import config_param_count, extract_subnet
    out = ROOT / "build" / "chip_smoke_nas"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        top = search_evolution.main([
            "--space", "tiny", "--ckpt", ckpt, "--param-min", "5e6", "--param-max", "6e6",
            "--population", "16", "--max-eval-batches", "4", "--epochs", "2",
            "--out", str(out / "evo.json"), "data.dataset=synthetic",
            f"data.batch_size={EVO_BATCH}"])
    text = buf.getvalue()
    line = next(s for s in text.splitlines() if s.startswith("evolution: ") and "scored" in s)
    n, wall = re.match(r"evolution: (\d+) candidates scored in ([\d.]+) s", line).groups()
    n_images = int(re.search(r"over (\d+) images", line).group(1))
    history = json.load(open(out / "evo.json"))["state"]["history"]
    score, best = top[0]
    dtype = torch.bfloat16
    m = create_model(AF, device="cuda", dtype=dtype)
    m.load_state_dict(restore_params(ckpt))
    m.eval()
    sub = extract_subnet(m, best)
    ips = throughput(sub, EVO_BATCH, 224, dtype, 20, 3)
    gen = torch.Generator("cuda").manual_seed(9)
    images = [smooth_images(gen, EVO_BATCH).to(dtype) for _ in range(2)]
    with torch.inference_mode():
        got = torch.cat([sub(x).float() for x in images])
        ref = torch.cat([m(x, config=best).float() for x in images])
    agree, decided, agree_decided = top1_agreement(got, ref)
    n_dec = round(decided * len(ref))
    print(f"cli.search_evolution (BASELINE configs[3]) bf16, {EVO_BATCH}-image batches x 4, "
          f"population 16, 2 epochs, window 5-6 M: {line[len('evolution: '):]}; best "
          f"{score:.4f} at depth {best['layer_num']}, embed {best['embed_dim'][0]}, "
          f"{config_param_count(best) / 1e6:.3f} M params [{card_info()}]")
    print(f"AutoFormerSubnet of the best config bf16 B={EVO_BATCH} "
          f"(autoformer_subnet_infer_throughput): {ips:.1f} img/s; top-1 vs the supernet at "
          f"that config {agree:.4f} over {len(ref)} images, {agree_decided:.4f} on the "
          f"{n_dec} decided (need >= 0.99 on >= 100) [{card_info()}]")
    check(len(history) > 16 and 5e6 <= config_param_count(best) <= 6e6, "evolution search")
    check(n_dec >= 100 and agree_decided >= 0.99, f"subnet vs supernet top-1 {agree_decided}")
    return {"candidates": int(n), "search_s": float(wall),
            "candidates_per_s": int(n) / float(wall),
            "eval_img_per_s": int(n) * n_images / float(wall), "subnet_img_per_s": ips,
            "best": best, "best_score": score}


def phase_cream_childnets() -> dict:
    """9t. cream_604 at 224 and cream_14 at 64, fp32 B=2 (TF32 off) on
    seeded weights (BN statistics away from 0/1) against the JAX package's
    logits (1e-3); cream_604 bf16 bs256 eval img/s (`throughput`);
    cream_481 bf16 bs256 on "fused" against "library": its K7 launches a
    forward (the depthwise-separable block and its four k3 layers), logits
    within 8 bf16 ulps of the largest |logit|, top-1 on decided images."""
    no_tf32()
    for name in ("cream_604", "cream_14"):
        g = np.load(DATA / f"{name}_seed0.npz")
        m = create_model(name, device="cuda")
        m.load_state_dict(seeded_state_dict(m, int(g["weight_seed"])))
        x = np.random.default_rng(int(g["input_seed"])).standard_normal(
            (2, m.img_size, m.img_size, 3)).astype(np.float32)
        logits = predict(m, torch.from_numpy(x)).cpu().numpy()
        err = float(np.abs(logits - g["logits"]).max())
        print(f"golden {name} fp32 B=2 at {m.img_size} vs JAX logits: max_abs_err={err:.3e} "
              f"bound=1e-3 (max |logit| {np.abs(g['logits']).max():.3f}) [{card_info()}]")
        check(bool(np.isfinite(logits).all()) and err <= 1e-3, f"{name} golden {err}")
    dtype = torch.bfloat16
    m = create_model("cream_604", device="cuda", dtype=dtype)
    m.load_state_dict(seeded_state_dict(m, 0))
    ips604 = throughput(m, BATCH, 224, dtype, 20, 3)
    gen = torch.Generator("cuda").manual_seed(10)
    x = smooth_images(gen, BATCH).to(dtype)
    out, launches = {}, {}
    DW_REFUSED.clear()
    for route in ("library", "fused"):
        m = create_model("cream_481", device="cuda", dtype=dtype)
        m.load_state_dict(seeded_state_dict(m, 0))
        set_dw_kernel(m, route)
        dwconv.reset_launches()
        out[route] = predict(m, x)
        torch.cuda.synchronize()
        launches[route] = dict(dwconv.LAUNCHES)
    ips481 = throughput(m, BATCH, 224, dtype, 20, 3)
    err = float((out["fused"] - out["library"]).abs().max())
    lim = 8 * float(bf16_ulp(out["library"].abs().max()))
    agree, decided, agree_decided = top1_agreement(out["fused"], out["library"])
    s1, s2 = dw3x3_path_sites(m.arch, m.stages, m.released_quirk)
    print(f"cream_604 bf16 B={BATCH} (cream_604_infer_throughput): {ips604:.1f} img/s; "
          f"cream_481 bf16 B={BATCH} fused: K7/K9 launches a forward {launches['fused']} "
          f"(want {s1} K7, {s2} K9: the ds block + its k3 layers; library "
          f"{launches['library']}), logits "
          f"vs library max |diff| {err:.3e} (bound 8 ulps {lim:.3e}), top-1 {agree:.4f} "
          f"({agree_decided:.4f} on the {decided:.3f} decided), {ips481:.1f} img/s fused; "
          f"depthwise sites the kernels refused (library conv instead): {dict(DW_REFUSED)} "
          f"[{card_info()}]")
    want = {"k7_fwd": s1, "k7_bwd": 0, "k8": 0, "k9_fwd": s2, "k9_bwd": 0}
    check(launches["fused"] == want and sum(launches["library"].values()) == 0,
          f"cream_481 K7/K9 launches {launches}, want {want} on fused")
    check(err <= lim, f"cream_481 fused vs library logits {err} > {lim}")
    check(not DW_REFUSED, f"cream_481: the kernels refused depthwise sites {dict(DW_REFUSED)}")
    return {"cream_604_img_per_s": ips604, "cream_481_fused_img_per_s": ips481,
            "k7_per_forward": launches["fused"]["k7_fwd"]}


def cream_dw_launches(stages, student, teacher) -> dict:
    """K7/K9 launches of one Cream supernet step on "fused": each path's
    sites (`models.cream.dw3x3_path_sites`), forward in the student's train
    pass and the teacher's eval pass, backward in the student's only."""
    s1, s2 = dw3x3_path_sites(student, stages)
    t1, t2 = dw3x3_path_sites(teacher, stages) if teacher is not None else (0, 0)
    return {"k7_fwd": s1 + t1, "k7_bwd": s1, "k8": 0, "k9_fwd": s2 + t2, "k9_bwd": s2}


def phase_cream_search() -> dict:
    """9u. `cli.search_cream.main` at 224 (fp32, bs16, 1,000 classes, 2
    epochs of 3 steps, the board open from epoch 1): the board fills, the
    meta step runs, the extracted childnet passes the CLI's <= 1e-4 check.
    Then the supernet's train step (`make_cream_train_step`, SGD 0.01 /
    0.9) in bf16 at bs128 over one seeded sequence of 13 paths (KD against
    its first path from step 2 on, meta value 0.5), from the same weights
    on "library" and on "fused": K7/K9 launches in each of the first 3 steps
    equal to the paths' sites (`cream_dw_launches`), the first step's loss
    within 2 bf16 ulps and grad norm within 2% between routes; after the
    other 10 paths once on each route, img/s of their 10 steps in 2
    interleaved rounds, peak memory; and the meta step's ms (bf16, the
    CLI's slice of a quarter of the batch, CUDA events, median of 5 after
    one)."""
    import tempfile

    from cream_tpu_torch.cli import search_cream
    from cream_tpu_torch.models.cream import SEARCH_STAGES, MetaMatchingHead
    from cream_tpu_torch.nas import cream as nas
    from cream_tpu_torch.train.optim import make_sgd
    calls = []
    real = search_cream.make_meta_update_step

    def counting(*a, **k):
        step = real(*a, **k)
        return lambda *b: calls.append(1) or step(*b)
    search_cream.make_meta_update_step = counting
    try:
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
            t0 = time.perf_counter()
            result = search_cream.main(["--epochs", "2", "--steps", "3", "--batch-size", "16",
                                        "--meta-sta-epoch", "0", "--lr", "0.01",
                                        "--img-size", "224", "--out", f"{tmp}/cream.json"])
            cli_s = time.perf_counter() - t0
    finally:
        search_cream.make_meta_update_step = real
    print(f"cli.search_cream at 224 fp32 bs16 (2 epochs of 3 steps): stages sta_num "
          f"{result['sta_num']}, board {result['history'][-1]['board']}, {len(calls)} meta "
          f"steps, best path {result['best_arch']} ({result['best_flops'] / 1e6:.1f} M MACs), "
          f"childnet vs supernet max |diff| {result['childnet_parity_maxdiff']:.2e} (bound "
          f"1e-4); {cli_s:.1f} s [{card_info()}]")
    check(result["history"][-1]["board"] >= 1 and calls, "search_cream: board or meta step")
    check(result["childnet_parity_maxdiff"] <= 1e-4, "search_cream childnet parity")

    dtype, routes = torch.bfloat16, ("library", "fused")
    gen = torch.Generator("cuda").manual_seed(11)
    x = smooth_images(gen, CREAM_BATCH).to(dtype)
    batch = {"image": x, "label": torch.randint(0, 1000, (CREAM_BATCH,), generator=gen,
                                                device="cuda")}
    rng = np.random.default_rng(0)
    paths = [nas.sample_architecture(rng, [d for _, d, _ in SEARCH_STAGES]).tolist()
             for _ in range(13)]
    models = {}
    for route in routes:
        models[route] = create_model("cream_supernet", device="cuda", dtype=dtype)
        models[route].load_state_dict(seeded_state_dict(models[route], 0))
        set_dw_kernel(models[route], route)
    step = nas.make_cream_train_step()

    def run(state, i):
        kd = i > 0
        return step(state, batch, paths[i % 13], paths[0] if kd else None, 0.5, kd)[1]

    states = {r: TrainState(models[r], make_sgd(0.01, momentum=0.9)) for r in routes}
    first, per_step = {}, []
    DW_REFUSED.clear()
    for route in routes:
        dwconv.reset_launches()
        first[route] = run(states[route], 0)
        torch.cuda.synchronize()
        if route == "fused":
            per_step.append(dict(dwconv.LAUNCHES))
            check(per_step[-1] == cream_dw_launches(SEARCH_STAGES, paths[0], None),
                  f"cream step 1: launches {per_step[-1]}")
            for i in (1, 2):
                dwconv.reset_launches()
                run(states[route], i)
                torch.cuda.synchronize()
                per_step.append(dict(dwconv.LAUNCHES))
                check(per_step[-1] == cream_dw_launches(SEARCH_STAGES, paths[i], paths[0]),
                      f"cream step {i + 1}: launches {per_step[-1]}")
        else:
            run(states[route], 1)
            run(states[route], 2)
            check(sum(dwconv.LAUNCHES.values()) == 0, "library route launched a dw kernel")
    # the rest of the sequence once on each route before the clock: a path's
    # first step meets conv shapes (k5, k7 choices) not seen before
    for route in routes:
        for i in range(3, 13):
            run(states[route], i)
    ips = {r: [] for r in routes}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for order in (routes, routes[::-1]):
        for route in order:
            counter = iter(range(3, 13))
            ms = timed_steps(lambda: run(states[route], next(counter)), 10)
            ips[route].append(CREAM_BATCH * 10 / sum(ms) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    sl = CREAM_BATCH // 4                      # the CLI's slice: a quarter of the batch
    meta = MetaMatchingHead(sl * 1000, device="cuda")
    meta_step = nas.make_meta_update_step(models["fused"], meta, 0.01, sl)
    kd = torch.softmax(torch.randn(sl, 1000, generator=gen, device="cuda"), -1)
    meta_ms = statistics.median(timed_steps(
        lambda: meta_step(x[:2 * sl], batch["label"][:2 * sl], paths[1], paths[0], kd), 6)[1:])
    l_ref, l_k = float(first["library"]["loss"]), float(first["fused"]["loss"])
    g_ref, g_k = float(first["library"]["grad_norm"]), float(first["fused"]["grad_norm"])
    loss_lim = 2 * 2.0 ** (np.floor(np.log2(l_ref)) - 7)
    k9 = [s["k9_fwd"] for s in per_step]
    print(f"train cream_supernet bf16 B={CREAM_BATCH} (cream_supernet_train_throughput), "
          f"seeded paths, KD from step 2: K7/K9 launches per step on fused {per_step} (the "
          f"paths' sites), library none; step 1 fused vs library: loss {l_k:.5f} vs "
          f"{l_ref:.5f} (|diff| {abs(l_k - l_ref):.2e}, bound {loss_lim:.2e}), grad_norm "
          f"{g_k:.4f} vs {g_ref:.4f} (rel {abs(g_k - g_ref) / g_ref:.2e}, bound 2e-2); img/s "
          f"(10 steps after each path once, CUDA events, rounds library, fused / fused, "
          f"library): "
          + "; ".join(f"{r} {' / '.join(f'{v:.1f}' for v in ips[r])}" for r in routes)
          + f"; peak memory {peak:.2f} GiB; meta step (bf16, slice {sl} x 1,000 classes) "
          f"{meta_ms:.2f} ms; depthwise sites the kernels refused: {dict(DW_REFUSED)} "
          f"[{card_info()}]")
    check(np.isfinite(l_k) and abs(l_k - l_ref) <= loss_lim, f"cream loss {l_k} vs {l_ref}")
    check(abs(g_k - g_ref) <= 2e-2 * g_ref, f"cream grad_norm {g_k} vs {g_ref}")
    check(sum(k9) > 0, "no K9 launch on the Cream path sequence")
    check(not DW_REFUSED, f"cream step: the kernels refused depthwise sites {dict(DW_REFUSED)}")
    return {"launches_per_step": per_step, "img_per_s": ips, "peak_gib": peak,
            "meta_ms": meta_ms, "cli_s": cli_s,
            "launches": {k: sum(s[k] for s in per_step) for k in per_step[0]}}


def evit_row(name: str, src: str, line: int, launches: int, err: float, t: dict,
             keys: tuple[str, ...], extra: dict) -> dict:
    """A kernel row of the JSON line; times summed over one EfficientViT-M5
    bs512 forward (each stage's time times its launches per forward)."""
    m5 = [n for n, *_ in EVIT_STAGES["efficientvit_m5"]]
    total = {k: sum(t[n][k] * t[n]["per_forward"] for n in m5) for k in keys}
    return {"name": name, "route": "cuda", "source": f"cream_tpu_torch/csrc/{src}",
            "replaces": f"cream_tpu/ops/pallas/{line}", "launches": launches,
            "max_abs_err": err, **total,
            "bound_by": max((t[n] for n in m5), key=lambda r: r["bound_ms"])["bound_by"],
            **extra}


def summed_over_blocks(times: dict, key: str, shapes=TINYVIT_SHAPES) -> float:
    """A per-shape time summed over the blocks of one forward (K1) or train
    step (K2) of the model whose stages `shapes` lists (TinyViT-21M-224's
    by default)."""
    return sum(times[n][key] * blocks for n, *_, blocks in shapes)


def main() -> None:
    t_start = time.time()
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: CUDA is not available")
    card = card_info()
    print(card)
    print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.time()
    path = build.build()
    build.load()
    print(f"build: {path.name} in {time.time() - t0:.2f} s")

    gen = torch.Generator("cuda").manual_seed(0)
    worst_k1, t1 = phase_k1(gen)
    worst_k2, t2 = phase_k2(gen)
    phase_grads(gen)
    phase_golden()
    phase_train_golden()
    k1_eval = phase_main()
    k1_train, k2_train = phase_train()
    for name in ("s3_tiny", "swin_tiny", "mini_swin_tiny"):
        phase_golden(name, DATA / f"{name}_seed0.npz")
    phase_train_golden("s3_tiny", DATA / "s3_tiny_train_seed0.npz")
    k1_swin = (phase_main("s3_tiny", S3T_BATCH, 12, rounds=4, lim_ulps=8)
               + phase_main("swin_tiny", S3T_BATCH, 12, rounds=1, lim_ulps=8,
                            top1_on_decided=True))
    phase_mini_swin()
    k1_s3_train, k2_s3_train = phase_train("s3_tiny", S3T_BATCH, 12)
    k1_distill, k2_distill = phase_distill()
    launches = (wa.LAUNCHES, wa.BWD_LAUNCHES)
    for name in CLIP_GOLDENS:
        phase_clip_golden(name)
    clip_pairs = {name: phase_clip_pairs(name, batch) for name, batch in CLIP_PAIRS}
    zero_shot = phase_zero_shot()
    teacher_ips = phase_clip_teacher()
    phase_clip_train_golden()
    clip_train = phase_clip_train()
    clip_steps = phase_clip_train_steps()
    clip_stages = phase_clip_pipeline()
    check((wa.LAUNCHES, wa.BWD_LAUNCHES) == launches, "the CLIP phases launched K1/K2")
    counts = kernel_counts()
    phase_deit_goldens()
    deit_eval = {name: phase_deit_eval(name) for name in DEIT_METRICS}
    deit_train = {name: phase_deit_train(name) for name in DEIT_METRICS}
    capture = phase_mini_swin_capture()
    check(kernel_counts() == counts, "the DeiT, Mini-DeiT or capture phases launched a kernel")
    t_nas = time.time()
    phase_autoformer_goldens()
    af_ckpt, af_train = phase_autoformer_train()
    evo = phase_evolution(af_ckpt)
    check(kernel_counts() == counts, "the AutoFormer phases launched a kernel")
    cream_eval = phase_cream_childnets()
    cream = phase_cream_search()
    nas_s = time.time() - t_nas
    worst_k5, t5 = phase_k5(gen)
    worst_k4, t4 = phase_k4(gen)
    phase_evit_golden()
    evit = {name: phase_evit_main(name, batch) for name, batch in EVIT_PATHS}
    evit_graph = {name: phase_evit_graph(name, batch) for name, batch in EVIT_PATHS}
    worst_dw, tdw = phase_dw(gen)
    phase_dw_grads(gen)
    phase_evit_train_golden()
    evit_train = phase_evit_train()
    tv_train = phase_tv_dw_train()
    worst_k6, t6 = phase_k6(gen)
    worst_k3, t3, k3_launches = phase_k3(gen)
    t10 = phase_k10(gen)
    t11 = phase_k11(gen)
    retime = phase_retime(gen)
    k6_launches, k11_eval = phase_tv_routes()
    k10_launches = phase_tv384()
    k11_train = phase_pin_train()

    rows = []
    for name, src, line, launches, err, t in (
            ("window_attention_fwd", "window_attention.cu", 190,
             k1_eval + k1_train + k1_swin + k1_s3_train + k1_distill, worst_k1, t1),
            ("window_attention_bwd", "window_attention_bwd.cu", 268,
             k2_train + k2_s3_train + k2_distill, worst_k2, t2)):
        rows.append({
            "name": name, "route": "cuda", "source": f"cream_tpu_torch/csrc/{src}",
            "replaces": f"cream_tpu/ops/pallas/window_attention.py:{line}",
            "launches": launches, "max_abs_err": err,
            **{k: summed_over_blocks(t, k)
               for k in ("ms", "host_ms", "plain_ms", "bound_ms", "library_host_ms")},
            "bound_by": t["stage2"]["bound_by"],
            "library_ms": summed_over_blocks(t, "library_ms"),
            "s3_tiny": {k: summed_over_blocks(t, k, S3T_SHAPES)
                        for k in ("ms", "plain_ms", "bound_ms", "library_ms")}})
    rows[0]["swin_base"] = {k: summed_over_blocks(t1, k, SWINB_SHAPES)
                            for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
    rows.append(evit_row(
        "cga_fused", "cga.cu", "cga.py:56", sum(v["cascade"][0] for v in evit.values()),
        worst_k4, t4, ("ms", "host_ms", "plain_ms", "plain_host_ms", "module_ms",
                       "module_host_ms", "bound_ms"),
        {"library_ms": None, "library_note": "no single PyTorch call computes the whole "
         "cascade; module_ms is the unfused plain-route CGA module on the same input",
         "forward_graph_ms": evit_graph}))
    rows.append(evit_row(
        "cga_core", "cga_core.cu", "cga_core.py:63", sum(v["core"][1] for v in evit.values()),
        worst_k5, t5, ("ms", "host_ms", "plain_ms", "plain_host_ms", "library_ms",
                       "library_host_ms", "bound_ms"), {}))
    for key, src_line, kind, stride, route in (
            ("k7_fwd", 167, "fwd", 1, "fused"), ("k7_bwd", 183, "bwd", 1, "fused"),
            ("k8", 338, "wgrad", 1, "wgrad"), ("k9_fwd", 474, "fwd", 2, "fused"),
            ("k9_bwd", 487, "bwd", 2, "fused")):
        sites = [(n, per) for n, *_, s, per in DW_M5 if s == stride]
        rows.append({
            "name": f"dwconv_{key}", "route": "cuda", "source": "cream_tpu_torch/csrc/dwconv.cu",
            "replaces": f"cream_tpu/ops/dwconv.py:{src_line}",
            "launches": evit_train[route][key] + tv_train[key] + cream["launches"][key],
            "max_abs_err": worst_dw[key],
            **{k: sum(tdw[n][kind][k] * per for n, per in sites)
               for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
            "bound_by": max((tdw[n][kind] for n, _ in sites),
                            key=lambda r: r["bound_ms"])["bound_by"],
            "tinyvit21m_step": per_step(tdw, DW_TINYVIT, kind, stride),
            "cream_supernet_step_launches": [n[key] for n in cream["launches_per_step"]]})
        if stride == 2:                                   # K9: each site's own times
            rows[-1]["sites"] = {n: {k: tdw[n][kind][k] for k in (
                "ms", "plain_ms", "library_ms", "bound_ms")} | {"per_step": per}
                for n, *_, s, per in DW_M5 + DW_TINYVIT if s == 2}
    name, *_ = K3_SHAPES[0]
    rows.append({"name": "bias_attention", "route": "cuda",
                 "source": "cream_tpu_torch/csrc/bias_attention.cu",
                 "replaces": "cream_tpu/ops/pallas/bias_attention.py:27",
                 "launches": k3_launches, "max_abs_err": worst_k3, **t3[name]})
    name, *_, per = MBCONV_SHAPES[0]
    rows.append({"name": "mbconv_fused", "route": "cuda", "source": "cream_tpu_torch/csrc/mbconv.cu",
                 "replaces": "cream_tpu/ops/pallas/mbconv.py:37", "launches": k6_launches,
                 "max_abs_err": worst_k6,
                 **{k: t6[name][k] * per
                    for k in ("ms", "host_ms", "plain_ms", "plain_host_ms", "module_ms",
                              "module_host_ms", "bound_ms")},
                 "bound_by": t6[name]["bound_by"], "library_ms": None,
                 "library_note": "no single PyTorch call computes the MBConv block; module_ms "
                 "is the unfused eval MBConv module on the same input"})
    name, *_, per = K10_SHAPES[0]
    rows.append({"name": "window_relayout", "route": "cuda",
                 "source": "cream_tpu_torch/csrc/window_relayout.cu",
                 "replaces": "cream_tpu/ops/pallas/window_relayout.py:29",
                 "launches": k10_launches, "max_abs_err": 0.0,
                 # per forward: per // 2 partitions and as many reverses
                 **{k: per // 2 * sum(t10[name][kind][k] for kind in ("partition", "reverse"))
                    for k in ("ms", "host_ms", "plain_ms", "bound_ms", "library_ms")},
                 "bound_by": t10[name]["partition"]["bound_by"]})
    rows.append({"name": "layout_pin", "route": "cuda", "source": "cream_tpu_torch/csrc/layout_pin.cu",
                 "replaces": "cream_tpu/ops/pallas/layout_pin.py:39",
                 "launches": k11_eval + k11_train, "max_abs_err": 0.0,
                 **{k: sum(t[k] for t in t11.values())
                    for k in ("ms", "host_ms", "plain_ms", "bound_ms", "library_ms")},
                 "bound_by": "bytes", "retime": retime["k11"]})
    for key in ("k9_fwd", "k9_bwd"):
        next(r for r in rows if r["name"] == f"dwconv_{key}")["tinyvit21m_step_retime"] = \
            retime[key]
    ids = {"window_attention_fwd": "K1", "window_attention_bwd": "K2", "bias_attention": "K3",
           "cga_fused": "K4", "cga_core": "K5", "mbconv_fused": "K6", "dwconv_k7_fwd": "K7",
           "dwconv_k7_bwd": "K7", "dwconv_k8": "K8", "dwconv_k9_fwd": "K9",
           "dwconv_k9_bwd": "K9", "window_relayout": "K10", "layout_pin": "K11"}
    for row in rows:
        row.update(id=ids[row["name"]], status="ported")
    rows.sort(key=lambda r: int(r["id"][1:]))
    check(sorted({r["id"] for r in rows}, key=lambda k: int(k[1:])) ==
          [f"K{i}" for i in range(1, 12)], "the kernels line does not list K1-K11")
    for key, t in (("K4", t4), ("K5", t5)):
        m0 = {k: sum(t[n][k] * t[n]["per_forward"] for n, *_ in EVIT_STAGES["efficientvit_m0"])
              for k in ("ms", "plain_ms", "bound_ms")}
        print(f"{key} per EfficientViT-M0 bf16 bs1024 forward: kernel {m0['ms']:.4f} ms, "
              f"plain {m0['plain_ms']:.4f} ms, bound {m0['bound_ms']:.4f} ms")
    print(f"kernel times are per TinyViT-21M-224 bf16 bs256 forward (K1) or train "
          f"step (K2), eval path K1 launches {k1_eval}, train path K1/K2 launches "
          f"{k1_train}/{k2_train} (under s3_tiny: per S3-Tiny bf16 bs128 forward or step; "
          f"its and Swin-T's eval paths K1 {k1_swin}, its train path K1/K2 "
          f"{k1_s3_train}/{k2_s3_train}; under swin_base: K1 per Swin-B bf16 bs256 forward; "
          f"the distillation path (save_logits, --check, the distill train CLI and the timed "
          f"distill steps) K1/K2 {k1_distill}/{k2_distill}); per EfficientViT-M5 bf16 bs512 "
          f"forward (K4, K5), "
          f"launches on the M5 bs512 + M0 bs1024 eval paths' cascade (K4) and core (K5) routes; "
          f"per EfficientViT-M5 bf16 bs512 train step (K7/K8/K9: the sum over its depthwise "
          f"sites; under tinyvit21m_step the sum over a TinyViT-21M-224 bf16 bs256 train "
          f"step's), launches on the M5 train path's fused (K7, K9) and wgrad (K8) routes "
          f"and the TinyViT train path's fused route; "
          f"per BiasAttention call at 4,096 windows (K3); per TinyViT-21M-224 bf16 bs256 "
          f"forward (K6: its 2 MBConvs; K11: its 3 stage "
          f"inputs, under retime the 3 interleaved rounds against x.clone(), as "
          f"tinyvit21m_step_retime for K9's forward and backward against cuDNN; K9's "
          f"sites: each stride-2 site's own times), launches on the "
          f"mbconv_kernel/pin_layouts/both routes (and the pinned train step for K11); per "
          f"TinyViT-21M-384 bf16 bs64 forward (K10: 6 partitions + 6 reverses)")
    print("CLIP serving path (plain PyTorch: no TPU kernel lies on it), bf16 bs256: " + ", ".join(
        f"{n} {r['pairs_per_s']:.1f} pairs/s (device {r['device_ms']:.2f} ms a pair forward, "
        f"idle share {r['idle_share']:.3f})" for n, r in clip_pairs.items())
        + f"; clip_vit_large14_224_classifier (21,841 classes) {teacher_ips:.1f} img/s; "
        f"zero-shot classifier build: tokenizer {zero_shot['tokenize_s']:.3f} s (host), text "
        f"passes {zero_shot['encode_s']:.3f} s [{card}]")
    print(f"CLIP training path (plain PyTorch: no TPU kernel lies on it): "
          f"tinyclip_39m_train_throughput bf16 bs{CLIP_TRAIN_BATCH} "
          f"{clip_train[False]['pairs_per_s']:.1f} pairs/s (peak {clip_train[False]['peak_gib']:.2f} "
          f"GiB; device {clip_train['profile']['device_ms']:.2f} ms a step, idle share "
          f"{clip_train['profile']['idle_share']:.3f}), with remat "
          f"{clip_train[True]['pairs_per_s']:.1f} pairs/s (peak {clip_train[True]['peak_gib']:.2f} "
          f"GiB); 20 steps: loss {clip_steps['losses'][0]:.4f} -> {clip_steps['losses'][-1]:.4f}; "
          f"fuse {clip_steps['params'][0]} -> {clip_steps['params'][1]} params (err "
          f"{clip_steps['fuse_err']:.2e}); pipeline params "
          f"{[r['params'] for r in clip_stages if 'params' in r]} [{card}]")
    print("DeiT iRPE / Mini-DeiT paths (plain PyTorch: no TPU kernel lies on them), bf16: "
          + "; ".join(f"{DEIT_METRICS[n]}_infer_throughput {deit_eval[n]['img_per_s']:.1f} img/s "
                      f"(bs{DEIT_BATCH}, device {deit_eval[n]['device_ms']:.2f} ms, idle "
                      f"{deit_eval[n]['idle_share']:.3f}), {DEIT_METRICS[n]}_train_throughput "
                      f"{deit_train[n]['img_per_s']:.1f} img/s (peak {deit_train[n]['peak_gib']:.2f} "
                      f"GiB, device {deit_train[n]['device_ms']:.2f} ms a step, idle "
                      f"{deit_train[n]['idle_share']:.3f})" for n in DEIT_METRICS)
          + f"; Mini-Swin-T capture: {capture['count']} qkv + {capture['count']} hidden states "
          f"[{card}]")
    print(f"one-shot NAS (phases 9q-9u, {nas_s:.1f} s): AutoFormer-T supernet train bf16 "
          f"bs{AF_BATCH} {af_train['img_per_s_median']:.1f} img/s median over sampled configs "
          f"({af_train['img_per_s_min']:.1f}-{af_train['img_per_s_max']:.1f}; largest "
          f"{af_train['img_per_s_largest']:.1f}; peak {af_train['peak_gib']:.2f} GiB); evolution "
          f"{evo['candidates']} candidates in {evo['search_s']:.2f} s "
          f"({evo['candidates_per_s']:.2f}/s, {evo['eval_img_per_s']:.1f} img/s), the best "
          f"subnet {evo['subnet_img_per_s']:.1f} img/s (bs{EVO_BATCH}); cream_604 "
          f"{cream_eval['cream_604_img_per_s']:.1f} img/s (bs{BATCH}); Cream supernet step "
          f"bf16 bs{CREAM_BATCH} library / fused "
          + " / ".join(f"{statistics.median(cream['img_per_s'][r]):.1f}"
                       for r in ("library", "fused"))
          + f" img/s (medians), meta step {cream['meta_ms']:.2f} ms; K7/K9 launches on the "
          f"Cream fused steps {cream['launches']} [{card}]")
    print(f"total wall time {time.time() - t_start:.1f} s, the build included")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
