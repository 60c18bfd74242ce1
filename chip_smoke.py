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
9a0. data-parallel step (`core.mesh`, `train.steps.data_parallel_mean`, the
     global BatchNorm of `nn.layers`): TinyViT-21M-224 bf16, global bs256,
     one AdamW step under a one-rank NCCL group in this process and, where
     two cards are present, on two ranks of a card each (`dp_rank`), against
     the one-card step on the same batch and weights: 10 + 10 K1/K2 launches
     a rank-step, loss within 2 bf16 ulps, grad norm within 2%, BN running
     stats within 1e-3 (L2, a tensor); img/s by CUDA events, plain, DP, DP,
     plain; the DP step's profile with the grad all-reduce's and the global
     BatchNorm's device ms
9a1. torchrun on the card (`--nproc_per_node=W`, W = min(cards, 2)) of
     cli.train, TinyViT-21M-224 bf16 global bs256 on the synthetic set, one
     epoch and its eval: finite losses, 10 + 10 K1/K2 launches a rank-step
9a2. core.dryrun.dryrun_multichip(W, device="cuda"): a data-parallel
     TinyViT-5M step and the contrastive gradient through the gather on W
     NCCL ranks (the third check, tensor parallelism, runs at even W)
9a3. tensor × data parallelism of the CLIP towers (`core.tensor_parallel`,
     the CLIP blocks split by heads, `train.steps.make_contrastive_step`):
     TinyCLIP-39M/16 bf16 at full width, bs256: the first vision and text
     blocks' model ranks 0 and 1 of 2 run without a group and summed by
     hand against the unsplit block (4 bf16 ulps); the contrastive Adam
     step at (data 1, model 1) under a one-rank NCCL group (the blocks
     split over it) against the plain step on the same global batch (loss
     within 5e-3, below 2 bf16 ulps; grad norm 2%; each tensor's grad,
     gathered whole, within 10% of its norm), pairs/s by CUDA events plain,
     TP, TP, plain, the model group's all-reduces' device ms; with 2 cards
     also (data 1, model 2), with 4 (data 2, model 2) and
     dryrun_multichip(4), each against the one-card step
 9a. Swin goldens: s3_tiny, swin_tiny and mini_swin_tiny fp32 (B=2) on
     seeded weights against the JAX package's logits stored in
     tests/data/torch_port/ (12, 12 and 0 fp32 K1 launches), and one fp32
     s3_tiny train step against the JAX loss and per-param grad norms
 9b. main path (Swin eval): s3_tiny bf16 bs128 through predict and
     throughput: 12 K1 launches per forward, top-1 agreement and logits
     (8 bf16 ulps) against use_kernel=False, img/s of both routes in 2
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
     path 0.1: the loss falls over 10 steps on one batch; train img/s
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
     "plain"-route module device times by CUDA-graph replay in 2
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
     CUDA-graph replay (the folds warmed first), 2 interleaved rounds
 14. K7/K8/K9 vs plain: the depthwise 3x3 kernels against their plain
     versions, bf16 and fp32, at EfficientViT-M5 bs512's depthwise sites,
     TinyViT-21M bs256's MBConv, local_conv and PatchMerging sites, three
     odd stride-2 maps, Cream's 19 site shapes at bs128 (`models.cream.
     dw3x3_sites`), the DARTS sites and the detectors' 8 M4 site shapes at
     canvas 512, bs16 (`models.retinanet.dw3x3_sites`); dx and dw the same
     bits on two launches; kernel,
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
     routes in 2 interleaved rounds, peak memory; M5 bs512 eval img/s with the
     depthwise convs on "library" and "fused"
 18. main path (TinyViT train, depthwise routes): TinyViT-21M-224 bf16
     bs256 through train.make_train_step with every depthwise ConvBN on
     "library" and on "fused": 12 + 12 K7 and 3 + 3 K9 launches per step
     on "fused", none on "library"; the first step's loss and grad norm
     against "library"; train img/s of both routes in 2 interleaved rounds
 19. K6 vs plain: the fused eval MBConv kernel against `fused_mbconv_ref` on
     a seeded module's fold at TinyViT-21M's and -5M/11M's stage-0 shapes
     (bs256 bf16; fp32 at bs32) and at maps its 14x14 bf16 tiles cut
     raggedly, the same bits on two launches; kernel, plain and
     unfused-module device times by CUDA-graph replay in 2 interleaved
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
     on 9r's checkpoint, 1,024 synthetic images at bf16 bs256, population 8,
     2 epochs, window 5-6 M: candidates/s, eval img/s; the best config's
     AutoFormerSubnet img/s and its top-1 against the supernet
 9t. Cream childnets: cream_604 (224) and cream_14 (64) fp32 goldens,
     cream_604 bf16 bs256 img/s, cream_481 on "fused" (K7/K9 at its k3 sites)
     against "library"; no depthwise site refused
 9u. Cream search: cli.search_cream.main at 224, then the supernet train
     step bf16 bs128 on "library" and "fused" over one seeded path sequence
     (K7/K9 launches per step, loss and grad norm between routes, img/s,
     peak memory, the meta step's ms); no depthwise site refused
 9v. CDARTS retrain: cdarts_retrain_imagenet (init 48, 224 px) on an example
     genotype holding every primitive but 'none': the fp32 B=2 golden, bf16
     bs256 on "fused" against "library" (K7/K9 launches a forward at the
     SepConv sites, 8 ulps), bf16 vs fp32 top-1 on decided images, eval
     img/s on both routes, bf16 bs128 train img/s and peak memory
 9w. DARTS search: darts_search_cifar's fp32 B=2 logits and alpha grads
     golden; CyclicSearcher's weight and alpha steps in bf16 at bs64 on
     "library" and "fused" (K7/K9 launches a step from the sites' rule, the
     first loss and grad norm between routes, ms a step in one round of
     3, device time and idle share from `profile`)
 9x. CDARTS staged search: cli.search_cdarts.main on the card at
     StageSearchConfig's width (steps and iterations cut), the JSON, a
     retrain network built from its genotypes, seconds a step and a
     discretization; one full-width fp32 joint step against the JAX record
 9y. NAS-Bench-201: the search network's ms a CyclicSearcher step at bs64,
     the infer network's fp32 golden and bf16 bs256 img/s
9z1. detector goldens: retinanet_efficientvit_m4 and mask_rcnn_efficientvit_m4
     fp32 at canvas 512, B=2 (TF32 off) against the JAX records in
     tests/data/torch_port/: outputs within 1e-3 of their largest (6 fp32 K4
     launches a forward), the decodes at score_thr 0 the same where the
     golden's scores are tie-free, one train step on "library" and "fused"
     (Mask R-CNN's samplers fed JAX's sampled order) against JAX's float64
     step: losses 1e-4, grad norms per `DET_GRAD_TOLS`
9z2. K4 vs plain at M4's canvas-512 stage shapes at bs16 (padded 7x7
     windows over 32x32, 7x7 over 16x16, 4x4 over 8x8), bf16 and fp32; bf16
     times by CUDA-graph replay against the plain version, the unfused module
     and the bound, summed per backbone forward
9z3. main path (detector eval): both at bf16 bs16, canvas 512: "cascade"
     within 8 bf16 ulps of "plain", 6 K4 launches a forward; forward and
     forward + decode img/s (the host's NMS included), peak memory, idle
     share, the forward's FLOPs against the bf16 peak
9z4. main path (detector train): both at bf16 bs16 through the CLIs' step
     on "library" and "fused" (K7/K9 at every enumerated site, none
     refused), img/s in 2 interleaved rounds, peak memory; 10 steps on one
     batch: the loss falls, all losses finite; idle share of a step
9z5. both detection CLIs --synthetic on the card (M4, canvas 512, B=2): the
     loss finite, the native COCO AP computed
9z6. the CLIP RN tower's pool repair: an RN50 stride-2 block's fp32 input
     grad on the card within 1e-5 of the CPU's (its largest)
9z7. DETR goldens: detr_resnet50 (iRPE-K) and detr_resnet18 fp32 (TF32 off)
     on a padded 2 x 160 x 224 batch against the JAX record (1e-3 of the
     largest); one DETR-R50 iRPE-K step against JAX's float64 step: the
     six Hungarian assignments equal, loss 1e-4, grad norms 1e-3
9z8. main path (DETR eval): DETR-R50 iRPE-K bf16 bs16 at canvas 512 with
     seeded pixel masks: forward and forward + post_process img/s, peak
     memory, idle share, FLOPs against the bf16 peak; bf16 top class per
     query against fp32 where the fp32 top-2 margin is above 4 bf16 ulps
9z9. main path (DETR train): the CLI's step at bf16 bs16 (one forward, six
     host matchings, AdamW after clipping): 10 steps on one batch, the loss
     falls, every loss finite; img/s, peak memory, idle share
9z10. CyDAS golden: cydas_seg fp32 at 97 x 129 (eval and the three heads)
     against the JAX record (1e-3), one train step on "library" and "fused"
     against JAX's float64 step (losses 1e-4, grad norms 1e-3)
9z11. main path (CyDAS eval): bf16 bs12 at 1024 x 2048: img/s, peak memory,
     idle share; the per-pixel argmax against fp32 (B=2) where the fp32
     top-2 margin is above 4 bf16 ulps
9z12. main path (CyDAS train): the CLI's step at bf16 bs12, crop 769, on
     "library" and "fused" (12 K7 launches a step at the six stride-1
     depthwise sites, none refused, the first loss within 2 bf16 ulps and
     the grad norm within 2% of library's), img/s in 2 interleaved rounds,
     peak memory; 10 steps on one batch: the loss falls, all finite
9z13. the DETR and segmentation CLIs --synthetic on the card
9z14. pixels on this host: the seeded train recipe (TrainAugConfig(),
     rand-m3-n2-mstd0.5, the colour-jitter route) and the eval resize +
     crop reproduce the stored JAX package's Pillow outputs
     (tests/data/torch_port/train_transform_seed0.npz) bit for bit; a BMP
     written here reads back bit for bit; the transform's ms an image
9z15. a generated ImageNet-style folder (10 classes, 768 train and 256 val
     BMPs at ImageNet's common sizes, in a temporary directory under build/):
     the train loader's img/s with the full recipe at bs256 and 8 worker
     processes (with their start, and steady over 4 batches after 2),
     beside the CPU count; the eval loader's
9z16. main path (training from the folder): cli.train.main, TinyViT-21M-224
     bf16 bs256, the full default recipe, 3 steps and the eval: 10 K1 + 10
     K2 launches a step, finite losses, the epoch's img/s; then the folder's
     steady train img/s (3 steps after 2, fed by the loader over 2 passes
     of the folder) beside the synthetic one, the idle share of 1 steady
     folder-fed steps, peak memory with remat_stem off and on
9z17. main path (eval from the folder): cli.eval.main, TinyViT-21M-224 bf16
     bs256 with --torch-ckpt: 10 K1 launches a forward, n = 256, img/s
9z18. JPEG data (a generated folder of 768 train and 512 val JPEGs at
     ImageNet's common sizes, quality 90, one val PNG, under build/): the
     native pipeline built from cream_tpu_torch/native/image_pipe.cc; its
     eval and RRC + flip decision rows equal the exact path's; eval pixels
     and full-scale train pixels within mean 0.012 / max 0.40 of the exact
     path, the PNG bit for bit; prescaled train rows counted
9z19. main path (eval from JPEGs): cli.eval.main, TinyViT-21M-224 bf16
     bs256, --torch-ckpt, data.native_loader True and False: n = 512, 10 K1
     launches a forward, img/s by the CLI's wall
9z20. the loaders alone on the JPEG folder: native and exact eval_loader and
     plain RRC + flip train_loader img/s, steady over passes 2-3
9z21. main path (training fed by the native pipeline): TinyViT-21M-224
     bf16 bs256 steps fed by train_loader(native=True) + prefetch: 10 + 10
     K1/K2 launches a step, finite losses, img/s over 4 steps after 2, the
     idle share of 3 more, the upload's and the loader's host ms, beside
     the synthetic step
9z22. image-text tar shards (2 x 256 pairs of the val JPEGs, one PNG) through
     data.shards.image_text_loader, native and exact, feeding TinyCLIP-39M/16
     bf16 bs256 pair forwards: pairs/s beside the synthetic pairs/s, pixels
     within the tolerance, tokens equal
9z23. the gated ConvBN variants (ops.bn's train-mode BN, the 1x1 channel
     product): TinyViT-21M-224 bf16 bs256 train steps on each and with both
     off, first loss within 2 bf16 ulps and grad norm within 2%, img/s in 2
     interleaved rounds, BN device ms
 24. main path (TinyViT-21M-384 eval): bf16 bs64, stage 2's 24x24 window
     through forward_windowed: 12 K10 launches per forward, logits bit for
     bit equal to the same forward with K10's two functions swapped for
     their plain versions, top-1 agreement with the all-plain model; img/s
 25. train check: one TinyViT-21M-224 bf16 bs256 train step with
     pin_layouts on: 3 K11 launches (none in the backward), the loss bit for
     bit the unpinned step's, per-tensor grads no further from it than a
     second unpinned step is
Every timing by CUDA graphs or CUDA events takes 5 reps of 10 calls, but a
call over 5 ms (a plain version, an unfused module, a whole forward), which
is timed over runs of ~20 ms in 3 reps (`timing_plan`).
The total wall time is printed, then the card, then a JSON summary of the
kernels (K1/K2 rows with an `s3_tiny` sum beside TinyViT's, K1's with a
`swin_base` sum); the last line
is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import copy
import functools
import gc
import json
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from cream_tpu_torch.cli.inference import predict  # noqa: E402
from cream_tpu_torch.cli.train import steps_per_epoch  # noqa: E402
from cream_tpu_torch.cli.speed_test import (card_info, throughput,  # noqa: E402
                                            timed_images_per_s, train_step_fn,
                                            train_throughput)
from cream_tpu_torch.core import mesh as port_mesh  # noqa: E402
from cream_tpu_torch.core.dryrun import dryrun_multichip, free_port, launch_ranks  # noqa: E402
from cream_tpu_torch.models import create_model  # noqa: E402
from cream_tpu_torch.models.clip import prune_clip, prune_clip_state_dict  # noqa: E402
from cream_tpu_torch.models.cream import dw3x3_path_sites, dw3x3_sites  # noqa: E402
from cream_tpu_torch.models import darts  # noqa: E402
from cream_tpu_torch.models.darts import EXAMPLE_GENOTYPE  # noqa: E402
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


# a call slower than SLOW_CALL_MS (a plain version, an unfused module, a
# whole forward) is timed over runs of ~SLOW_RUN_MS in SLOW_REPS reps
SLOW_CALL_MS, SLOW_RUN_MS, SLOW_REPS = 5.0, 20.0, 3


def warm_ms(fn) -> float:
    """One call of `fn` (its warm-up), timed by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def timing_plan(first_ms: float, iters: int, reps: int) -> tuple[int, int]:
    """(iters, reps) for a callable whose warm-up call took `first_ms`:
    as asked, or for a call over SLOW_CALL_MS ~SLOW_RUN_MS of calls a rep
    in SLOW_REPS reps."""
    if first_ms <= SLOW_CALL_MS:
        return iters, reps
    return max(1, min(iters, round(SLOW_RUN_MS / first_ms))), min(reps, SLOW_REPS)


def cuda_ms(fn, iters: int = 10, reps: int = 5) -> float:
    """Median over `reps` of the mean time of `iters` calls, CUDA events
    (fewer for a slow call: `timing_plan`)."""
    iters, reps = timing_plan(warm_ms(fn), iters, reps)
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
    graph, the median over `reps` replays (CUDA events) over `iters` (fewer
    for a slow call: `timing_plan`). The host's cost of issuing each call,
    which `cuda_ms` measures for a launch shorter than it, is out."""
    iters, reps = timing_plan(warm_ms(fn), iters, reps)
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


# interleaved rounds of CUDA-graph timing a kernel check takes
GRAPH_ROUNDS = 2


def graph_rounds(*fns, rounds: int = GRAPH_ROUNDS) -> list[list[float]]:
    """Each fn's `graph_ms` in each of `rounds` rounds, the fns timed in
    turn each round, so a drift of the card's clock falls on all of them."""
    times = [[] for _ in fns]
    for _ in range(rounds):
        for t, fn in zip(times, fns):
            t.append(graph_ms(fn))
    return times


def interleaved_graph_ms(*fns, rounds: int = GRAPH_ROUNDS) -> list[float]:
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


def check_step_golden(tag: str, g, loss, grads: dict, per_tensor: float = 1e-3,
                      grad_norm: float = 1e-4, of_largest: float = 0.0) -> None:
    """A step's loss and raw grads against a JAX golden's loss (1e-4
    relative), global grad norm (`grad_norm` relative) and per-tensor grad
    norms (`per_tensor` relative, plus `of_largest` of the largest
    tensor's norm)."""
    loss_err = abs(float(loss) - float(g["loss"])) / float(g["loss"])
    gn_err = abs(float(global_norm(grads.values())) - float(g["grad_norm"])) / float(g["grad_norm"])
    check(sorted(grads) == list(g["names"]), "train golden: param names differ")
    got = np.asarray([grads[n].norm().item() for n in g["names"]])
    # grads that are zero up to float noise (TinyViT: the last fc2 bias of
    # stages 1 and 2, before PatchMerging's train-mode BN) at 1e-7 of the norm
    floor = 1e-7 * float(g["grad_norm"]) + of_largest * float(g["grad_norms"].max())
    diff = np.abs(got - g["grad_norms"])
    excess = diff - (per_tensor * g["grad_norms"] + floor)
    above = g["grad_norms"] > 100 * floor
    worst = float((diff[above] / g["grad_norms"][above]).max())
    print(f"{tag} fp32 B=2 vs JAX: loss rel err {loss_err:.2e} "
          f"(bound 1e-4), grad_norm rel err {gn_err:.2e} (bound {grad_norm:.0e}), per-tensor "
          f"grad norms worst rel err {worst:.2e} over the {int(above.sum())} tensors above "
          f"100x the floor (bound {per_tensor:.0e}); the {int((~above).sum())} below it within "
          f"{float(diff[~above].max(initial=0.0)):.1e} (floor {floor:.1e}; excess over the "
          f"bound {float(excess.max()):.1e})")
    check(loss_err <= 1e-4, f"{tag} loss rel err {loss_err}")
    check(gn_err <= grad_norm, f"{tag} grad_norm rel err {gn_err}")
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
    batch = next(iter(train_loader(train_cli.build_dataset(cfg, train=True), BATCH, 0, 0,
                                   cfg.data.img_size, 8,
                                   transform=train_cli.build_train_transform(cfg))))
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
    synchronize, or CUDA events): the synthetic loader's batch (8 workers,
    the trainer's full seeded recipe),
    the seeded pair mixup (its host draws and the device mix), Swin-B-22k's
    forward, the remap + softmax + top-K, the store's read of a batch
    (native codec) and the student's mixup replay on bf16 images. Not the
    main path: its K1 launches are not counted."""
    from cream_tpu_torch.cli.train import build_dataset, build_train_transform
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
    ds = build_dataset(cfg, train=True)
    it = iter(train_loader(ds, SWINB_BATCH, 0, 0, cfg.data.img_size, 8,
                           transform=build_train_transform(cfg)))
    t0 = time.perf_counter()
    batches = [next(it) for _ in range(2)]
    loader_ms = (time.perf_counter() - t0) * 1e3 / len(batches)
    del it
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
          f"{loader_ms:.1f} ms (host, 8 workers, mean of {len(batches)} batches, the "
          f"workers' start included), seeded pair "
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
    CUDA-graph replay in 2 interleaved rounds (CUDA events beside them),
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
                print(f"k4 time {name} bf16 W={W} (device, CUDA graph, median of {GRAPH_ROUNDS} "
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
    route, 2 interleaved rounds, so the host's launch overhead is out of
    the time; the cached folds are warmed first. The captured cascade forward holds one K4
    launch per attention block."""
    dtype = torch.bfloat16
    model = create_model(name, device="cuda", dtype=dtype)
    model.load_state_dict(seeded_state_dict(model, 0))
    x = smooth_images(torch.Generator("cuda").manual_seed(2), batch).to(dtype)
    blocks = sum(isinstance(m, CascadedGroupAttention) for m in model.modules())
    routes = ("cascade", "core", "plain")

    calls = dict.fromkeys(routes, 0)

    def forward(route):
        def run():
            calls[route] += 1
            model.set_attn_kernel(route)
            return model(x)
        return run
    with torch.inference_mode():
        for route in routes:
            forward(route)()                     # the folds, cached
        torch.cuda.synchronize()
        n0, c0 = cga.LAUNCHES, calls["cascade"]
        rounds = graph_rounds(*(forward(r) for r in routes))
    # each cascade forward graph_ms runs or captures issues one K4 a block
    n = calls["cascade"] - c0
    check(cga.LAUNCHES - n0 == n * blocks and n >= 2 * GRAPH_ROUNDS,
          f"{name}: {cga.LAUNCHES - n0} K4 launches issued for {n} cascade forwards")
    ms = {r: statistics.median(t) for r, t in zip(routes, rounds)}
    print(f"graph {name} bf16 B={batch} eval forward (device, CUDA graph, {GRAPH_ROUNDS} interleaved rounds "
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
    depthwise shapes, at odd stride-2 maps, at Cream's 19 site shapes
    (bs128), at the DARTS search (bs64) and CDARTS retrain (bs256) sites,
    at the detectors' EfficientViT-M4 sites (canvas 512, bs16) and at
    CyDAS's six sites (bs12, crop 769), bf16 and fp32; dw bits on two
    launches; bf16 times at the M5, TinyViT and CyDAS sites. Returns the worst bf16 errors by kernel and the times
    by shape."""
    worst = dict.fromkeys(dwconv.LAUNCHES, 0.0)
    times = {}
    for name, B, H, W, C, stride, per in (DW_M5 + DW_TINYVIT + DW_S2_ODD + DW_CREAM
                                           + darts_dw_sites() + det_dw_sites()
                                           + cydas_dw_sites()):
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
    train img/s in 2 interleaved rounds of 5 steps after 2. Returns the
    "fused" route's launches."""
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
    warmup, iters = 2, 5
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
    for order in (routes, routes[::-1]):
        for route in order:
            ips[route].append(train_throughput(models[route], BATCH, 224, dtype, iters, warmup))
    launches = dict(dwconv.LAUNCHES)
    runs = 2 * (warmup + iters)
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
          f"library, fused / reversed): " + "; ".join(
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
    n_steps, warmup, iters = 10, 2, 5
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
    # large, so each route is timed twice, interleaved (four times before
    # the image-folder phases took the smoke's time)
    for order in (DW_ROUTES[::-1],):
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
          f"fused, wgrad / reversed): " + "; ".join(
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
    replay in 2 interleaved rounds (CUDA-events times beside them), against
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
                k_ms, p_ms, u_ms = interleaved_graph_ms(kern, plain, module, rounds=2)
                check(mbconv.LAUNCHES > n0, f"K6 {name}: the timing did not launch K6")
                t = dict(ms=k_ms, host_ms=cuda_ms(kern), plain_ms=p_ms,
                         plain_host_ms=cuda_ms(plain), module_ms=u_ms,
                         module_host_ms=cuda_ms(module), per_forward=per)
            t["bound_ms"], t["bound_by"] = k6_bound_ms(B, H, W, C, hid, dtype)
            t["floor_ms"] = k6_floor_ms(B, H, W, C, hid)
            times[name] = t
            print(f"k6 time {name} bf16 B={B} (device, CUDA graph, median of 2 interleaved "
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


@functools.lru_cache(maxsize=None)
def zero_shot_merges() -> tuple:
    """A BPE merges list learned from OpenAI's zero-shot class names and
    templates (500 merges; the released file is not in the repository),
    once a process: phase_zero_shot and phase_jpeg_shards share it."""
    from cream_tpu_torch.data.tokenizer import learn_merges
    from cream_tpu_torch.train.zero_shot import openai_imagenet_constants
    names, templates = openai_imagenet_constants()
    return tuple(learn_merges(names + templates, 500))


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
    from cream_tpu_torch.data.tokenizer import write_merges
    from cream_tpu_torch.train.zero_shot import openai_imagenet_constants
    torch.backends.cuda.matmul.allow_tf32 = False
    templates = openai_imagenet_constants()[1]
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        bpe = Path(tmp) / "merges.txt.gz"
        t0 = time.perf_counter()
        write_merges(bpe, zero_shot_merges())
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
    5 steps after 3), peak memory; the first step's loss the same with
    remat within 2 bf16 ulps, and less memory with it; the device time by
    kind of op of the step without remat (cli.profile_step.profile)."""
    from cream_tpu_torch.cli.profile_step import profile
    from cream_tpu_torch.cli.speed_test import (tinyclip_train_step_fn,
                                                tinyclip_train_throughput)
    out = {}
    for remat in (False, True):
        model = create_model(TINYCLIP, device="cuda", dtype=torch.bfloat16, remat=remat)
        model.load_state_dict(seeded_state_dict(model, 0))
        out[remat] = tinyclip_train_throughput(model, batch, 3, 2)
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
    population 8, 2 epochs, parameter window 5-6 M
    (around AutoFormer-T's 5.7 M): candidates scored per second and eval
    img/s (the CLI's own clock around the search); the best config's
    `AutoFormerSubnet` bf16 bs256 through `throughput`, and its top-1
    against the supernet at that config on 512 low-frequency images (>= 99% on those whose top-2 margin
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
            "--population", "8", "--max-eval-batches", "4", "--epochs", "2",
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
          f"population 8, 2 epochs, window 5-6 M: {line[len('evolution: '):]}; best "
          f"{score:.4f} at depth {best['layer_num']}, embed {best['embed_dim'][0]}, "
          f"{config_param_count(best) / 1e6:.3f} M params [{card_info()}]")
    print(f"AutoFormerSubnet of the best config bf16 B={EVO_BATCH} "
          f"(autoformer_subnet_infer_throughput): {ips:.1f} img/s; top-1 vs the supernet at "
          f"that config {agree:.4f} over {len(ref)} images, {agree_decided:.4f} on the "
          f"{n_dec} decided (need >= 0.99 on >= 100) [{card_info()}]")
    check(len(history) > 8 and 5e6 <= config_param_count(best) <= 6e6, "evolution search")
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


# the Cream step's seeded path sequence: 3 checked steps, then every path's
# first step once a route before the clock times the rest
CREAM_PATHS = 5


def phase_cream_search() -> dict:
    """9u. `cli.search_cream.main` at 224 (fp32, bs16, 1,000 classes, 2
    epochs of 3 steps, the board open from epoch 1): the board fills, the
    meta step runs, the extracted childnet passes the CLI's <= 1e-4 check.
    Then the supernet's train step (`make_cream_train_step`, SGD 0.01 /
    0.9) in bf16 at bs128 over one seeded sequence of CREAM_PATHS paths
    (KD against its first path from step 2 on, meta value 0.5), from the
    same weights on "library" and on "fused": K7/K9 launches in each of the
    first 3 steps equal to the paths' sites (`cream_dw_launches`), the first
    step's loss within 2 bf16 ulps and grad norm within 2% between routes;
    after the other paths once on each route, img/s of their steps in one
    round, peak memory; and the meta step's ms (bf16, the CLI's slice of a
    quarter of the batch, CUDA events, median of 3 after one)."""
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
             for _ in range(CREAM_PATHS)]
    models = {}
    for route in routes:
        models[route] = create_model("cream_supernet", device="cuda", dtype=dtype)
        models[route].load_state_dict(seeded_state_dict(models[route], 0))
        set_dw_kernel(models[route], route)
    step = nas.make_cream_train_step()

    def run(state, i):
        kd = i > 0
        return step(state, batch, paths[i % CREAM_PATHS], paths[0] if kd else None, 0.5, kd)[1]

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
        for i in range(3, CREAM_PATHS):
            run(states[route], i)
    ips = {r: [] for r in routes}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for order in (routes,):
        for route in order:
            counter = iter(range(3, CREAM_PATHS))
            ms = timed_steps(lambda: run(states[route], next(counter)), CREAM_PATHS - 3)
            ips[route].append(CREAM_BATCH * (CREAM_PATHS - 3) / sum(ms) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    sl = CREAM_BATCH // 4                      # the CLI's slice: a quarter of the batch
    meta = MetaMatchingHead(sl * 1000, device="cuda")
    meta_step = nas.make_meta_update_step(models["fused"], meta, 0.01, sl)
    kd = torch.softmax(torch.randn(sl, 1000, generator=gen, device="cuda"), -1)
    meta_ms = statistics.median(timed_steps(
        lambda: meta_step(x[:2 * sl], batch["label"][:2 * sl], paths[1], paths[0], kd), 4)[1:])
    l_ref, l_k = float(first["library"]["loss"]), float(first["fused"]["loss"])
    g_ref, g_k = float(first["library"]["grad_norm"]), float(first["fused"]["grad_norm"])
    loss_lim = 2 * 2.0 ** (np.floor(np.log2(l_ref)) - 7)
    k9 = [s["k9_fwd"] for s in per_step]
    print(f"train cream_supernet bf16 B={CREAM_BATCH} (cream_supernet_train_throughput), "
          f"seeded paths, KD from step 2: K7/K9 launches per step on fused {per_step} (the "
          f"paths' sites), library none; step 1 fused vs library: loss {l_k:.5f} vs "
          f"{l_ref:.5f} (|diff| {abs(l_k - l_ref):.2e}, bound {loss_lim:.2e}), grad_norm "
          f"{g_k:.4f} vs {g_ref:.4f} (rel {abs(g_k - g_ref) / g_ref:.2e}, bound 2e-2); img/s "
          f"({CREAM_PATHS - 3} steps after each path once, CUDA events, one round library, "
          f"fused): "
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


# ---- CDARTS, DARTS and NAS-Bench-201 (no TPU kernel lies on JAX's path;
# SepConv's depthwise 3x3 sites reach K7/K9 on "fused") ----
RETRAIN = "cdarts_retrain_imagenet"
RETRAIN_GENOTYPES = [EXAMPLE_GENOTYPE] * 3
RETRAIN_TRAIN_BATCH, DARTS_BATCH = 128, 64


def darts_dw_sites() -> list:
    """The DARTS search network's depthwise 3x3 site shapes at its step's
    bs64 and the retrain network's at bs256 (`models.darts.dw3x3_sites`,
    traced on the meta device), held to the plain versions in `phase_dw`."""
    search = create_model("darts_search_cifar", device="meta")
    a = darts.init_alphas(torch.Generator().manual_seed(0))
    retrain = create_model(RETRAIN, genotypes=RETRAIN_GENOTYPES, device="meta")
    return ([(f"darts_search_{i}", *shape, stride, 0) for i, (stride, shape) in
             enumerate(darts.dw3x3_sites(search, DARTS_BATCH, a["normal"], a["reduce"]))]
            + [(f"cdarts_retrain_{i}", *shape, stride, 0)
               for i, (stride, shape) in enumerate(darts.dw3x3_sites(retrain, BATCH))])


class RecordingOpt:
    """An optimizer that keeps the grads it is handed."""

    def __init__(self, inner):
        self.inner, self.grads = inner, None

    def step(self, params, grads):
        self.grads = dict(grads)
        self.inner.step(params, grads)


def phase_cdarts_retrain() -> dict:
    """9v. cdarts_retrain_imagenet (init 48, 224 px, 5/5/4 cells) on the
    example genotype (every primitive but 'none'): the fp32 B=2 logits (TF32
    off) on seeded weights against the JAX package's (1e-3); bf16 bs256 on
    "fused" against "library" (K7/K9 launches a forward at the SepConv
    sites, logits within 8 bf16 ulps of the largest |logit|); bf16 vs fp32
    top-1 on 512 low-frequency images, counted on those whose fp32 top-2
    margin is above 4 bf16 ulps (need >= 0.99 on >= 100); bf16 bs256 eval
    img/s on both routes (`throughput`) and bf16 bs128 train img/s
    (`train_throughput`) with peak memory."""
    no_tf32()
    g = np.load(DATA / f"{RETRAIN}_seed0.npz")
    ref = create_model(RETRAIN, genotypes=RETRAIN_GENOTYPES, device="cuda")
    sd = seeded_state_dict(ref, int(g["weight_seed"]))
    ref.load_state_dict(sd)
    x = np.random.default_rng(int(g["input_seed"])).standard_normal(
        (2, 224, 224, 3)).astype(np.float32)
    logits = predict(ref, torch.from_numpy(x)).cpu().numpy()
    err = float(np.abs(logits - g["logits"]).max())
    print(f"golden {RETRAIN} fp32 B=2 at 224 vs JAX logits: max_abs_err={err:.3e} bound=1e-3 "
          f"(max |logit| {np.abs(g['logits']).max():.3f}) [{card_info()}]")
    check(bool(np.isfinite(logits).all()) and err <= 1e-3, f"{RETRAIN} golden {err}")
    dtype, gen = torch.bfloat16, torch.Generator("cuda").manual_seed(12)
    images = [smooth_images(gen, BATCH) for _ in range(512 // BATCH)]
    models, first, launches = {}, {}, {}
    DW_REFUSED.clear()
    for route in ("library", "fused"):
        models[route] = create_model(RETRAIN, genotypes=RETRAIN_GENOTYPES, device="cuda",
                                     dtype=dtype)
        models[route].load_state_dict(sd)
        set_dw_kernel(models[route], route)
        dwconv.reset_launches()
        first[route] = predict(models[route], images[0])
        torch.cuda.synchronize()
        launches[route] = dict(dwconv.LAUNCHES)
    s1, s2 = darts.dw3x3_path_sites(models["fused"])
    want_l = {"k7_fwd": s1, "k7_bwd": 0, "k8": 0, "k9_fwd": s2, "k9_bwd": 0}
    diff = float((first["fused"] - first["library"]).abs().max())
    lim = 8 * float(bf16_ulp(first["library"].abs().max()))
    bf = torch.cat([first["library"]] + [predict(models["library"], x) for x in images[1:]])
    fp = torch.cat([predict(ref, x) for x in images])
    del ref
    agree, decided, agree_decided = top1_agreement(bf, fp)
    n_decided = round(decided * len(fp))
    ips = {r: throughput(models[r], BATCH, 224, dtype, 20, 3) for r in ("library", "fused")}
    del models["fused"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    train_ips = train_throughput(models["library"], RETRAIN_TRAIN_BATCH, 224, dtype, 10, 3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"main {RETRAIN} bf16 B={BATCH} (cdarts_retrain_imagenet_infer_throughput): "
          f"library {ips['library']:.1f} img/s, fused {ips['fused']:.1f} img/s (CUDA events, 20 "
          f"forwards after 3); fused: K7/K9 launches a forward {launches['fused']} (want "
          f"{want_l}; library {launches['library']}), logits vs library max |diff| {diff:.3e} "
          f"(bound 8 ulps {lim:.3e}); bf16 vs fp32 top-1 {agree:.4f} over {len(fp)} images, "
          f"{agree_decided:.4f} on the {n_decided} decided (need >= 0.99 on >= 100); train bf16 "
          f"B={RETRAIN_TRAIN_BATCH} (cdarts_retrain_imagenet_train_throughput) {train_ips:.1f} "
          f"img/s (AdamW, 10 steps after 3), peak memory {peak:.2f} GiB; depthwise sites the "
          f"kernels refused: {dict(DW_REFUSED)} [{card_info()}]")
    check(launches["fused"] == want_l and sum(launches["library"].values()) == 0,
          f"{RETRAIN} launches {launches}, want {want_l} on fused")
    check(diff <= lim, f"{RETRAIN} fused vs library logits {diff} > {lim}")
    check(n_decided >= 100 and agree_decided >= 0.99,
          f"{RETRAIN}: bf16 vs fp32 top-1 {agree_decided} on {n_decided} decided images")
    check(not DW_REFUSED, f"{RETRAIN}: the kernels refused depthwise sites {dict(DW_REFUSED)}")
    check(np.isfinite(train_ips), f"{RETRAIN} train")
    return {"img_per_s": ips, "train_img_per_s": train_ips, "peak_gib": peak,
            "launches": launches["fused"]}


def phase_darts_search(rounds: int = 1, per: int = 1) -> dict:
    """9w. darts_search_cifar (C 16, 8 layers, 4 nodes): the fp32 B=2 logits
    and CE alpha grads (eval mode, TF32 off) on seeded weights and the
    stored alphas against the JAX package's, run in float64 (1e-3; grads
    1e-3 of their largest); then CyclicSearcher's weight step (SGD 0.05 / 0.9) and alpha
    step (Adam 3e-4 b1 0.5, against eval-net logits, L1 on the
    parameter-free ops) in bf16 at bs64 on 32x32 low-frequency images from
    the same weights and alphas on "library" and "fused": K7/K9 launches of
    each step equal to `dw3x3_step_launches` on fused, none on library; the
    first weight step's loss within 2 bf16 ulps and grad norm within 2%
    between routes; ms a weight step and an alpha step (CUDA events) in
    `rounds` interleaved rounds of `per` steps; device time and idle share
    of one weight step on "fused" (`profile`; ~33,000 launches, which the
    profiler takes seconds to read; its wall includes the profiler's host
    cost); no depthwise site refused."""
    from cream_tpu_torch.cli.profile_step import profile
    from cream_tpu_torch.nas.cdarts import make_alpha_adam, make_alpha_step, make_weight_step
    from cream_tpu_torch.train.optim import make_sgd
    no_tf32()
    g = np.load(DATA / "darts_search_cifar_seed0.npz")
    m = create_model("darts_search_cifar", device="cuda")
    sd = seeded_state_dict(m, int(g["weight_seed"]))
    m.load_state_dict(sd)
    a = {k: torch.tensor(g[f"alphas_{k}"], device="cuda", requires_grad=True)
         for k in ("normal", "reduce")}
    logits = m.eval()(torch.from_numpy(g["image"]).cuda(), a["normal"], a["reduce"])
    F.cross_entropy(logits, torch.from_numpy(g["label"]).cuda()).backward()
    err = float(np.abs(logits.detach().cpu().numpy() - g["logits"]).max())
    gerr = max(float(np.abs(a[k].grad.cpu().numpy() - g[f"grad_{k}"]).max()
                     / np.abs(g[f"grad_{k}"]).max()) for k in a)
    print(f"golden darts_search_cifar fp32 B=2 vs JAX (float64): logits max_abs_err={err:.3e} bound=1e-3, "
          f"alpha grads max err / max |grad| {gerr:.3e} bound=1e-3 [{card_info()}]")
    check(err <= 1e-3 and gerr <= 1e-3, f"darts_search golden {err} {gerr}")
    dtype, gen = torch.bfloat16, torch.Generator("cuda").manual_seed(13)
    tb = {"image": smooth_images(gen, DARTS_BATCH, 32).to(dtype),
          "label": torch.randint(0, 10, (DARTS_BATCH,), generator=gen, device="cuda")}
    vb = {"image": smooth_images(gen, DARTS_BATCH, 32).to(dtype),
          "label": torch.randint(0, 10, (DARTS_BATCH,), generator=gen, device="cuda")}
    eval_logits = torch.randn(DARTS_BATCH, 10, generator=gen, device="cuda")
    routes, runs, first, per_step = ("library", "fused"), {}, {}, {}
    DW_REFUSED.clear()
    for route in routes:
        mm = create_model("darts_search_cifar", device="cuda", dtype=dtype)
        mm.load_state_dict(sd)
        set_dw_kernel(mm, route)
        alphas = darts.init_alphas(torch.Generator("cuda").manual_seed(0), device="cuda")
        w = make_weight_step(mm, make_sgd(0.05, momentum=0.9))
        al = make_alpha_step(mm, make_alpha_adam())
        runs[route] = (lambda w=w, alphas=alphas: w(alphas, tb),
                       lambda al=al, alphas=alphas: al(alphas, vb, eval_logits))
        dwconv.reset_launches()
        first[route] = runs[route][0]()
        torch.cuda.synchronize()
        launches_w = dict(dwconv.LAUNCHES)
        dwconv.reset_launches()
        runs[route][1]()
        torch.cuda.synchronize()
        per_step[route] = (launches_w, dict(dwconv.LAUNCHES))
        want = ((darts.dw3x3_step_launches(mm), darts.dw3x3_step_launches(mm, True))
                if route == "fused" else (dict.fromkeys(dwconv.LAUNCHES, 0),) * 2)
        check(per_step[route] == want, f"darts search {route}: launches {per_step[route]}, "
                                       f"want {want}")
    ms = {r: {"weight": [], "alpha": []} for r in routes}
    for i in range(rounds):
        for route in (routes if i % 2 == 0 else routes[::-1]):
            for kind, fn in zip(("weight", "alpha"), runs[route]):
                ms[route][kind].append(statistics.median(timed_steps(fn, per)))
    prof = {"fused": profile(runs["fused"][0], steps=1, warmup=0, top=6)}
    l_ref, l_k = float(first["library"]["loss"]), float(first["fused"]["loss"])
    g_ref, g_k = float(first["library"]["grad_norm"]), float(first["fused"]["grad_norm"])
    loss_lim = 2 * 2.0 ** (np.floor(np.log2(l_ref)) - 7)
    med = {r: {k: statistics.median(v) for k, v in ms[r].items()} for r in routes}
    print(f"train darts_search_cifar bf16 B={DARTS_BATCH} 32x32 (darts_search_step_ms): K7/K9 "
          f"launches a weight step / an alpha step on fused {per_step['fused'][0]} / "
          f"{per_step['fused'][1]} (the sites' rule), library none; first weight step fused vs "
          f"library: loss {l_k:.5f} vs {l_ref:.5f} (|diff| {abs(l_k - l_ref):.2e}, bound "
          f"{loss_lim:.2e}), grad_norm {g_k:.4f} vs {g_ref:.4f} (rel "
          f"{abs(g_k - g_ref) / g_ref:.2e}, bound 2e-2); ms a step (CUDA events, medians of "
          f"{per} in {rounds} interleaved rounds): " + "; ".join(
              f"{r} weight {' / '.join(f'{v:.2f}' for v in ms[r]['weight'])}, alpha "
              f"{' / '.join(f'{v:.2f}' for v in ms[r]['alpha'])}" for r in routes)
          + "; profile of a weight step: " + "; ".join(
              f"{r} wall {prof[r]['wall_ms']:.2f} ms, device {prof[r]['device_ms']:.2f} ms, idle "
              f"share {prof[r]['idle_share']:.3f}, {prof[r]['launches']:.0f} launches, by kind "
              + ", ".join(f"{k} {v:.2f}" for k, v in list(prof[r]["by_kind_ms"].items())[:6])
              for r in prof)
          + f"; depthwise sites the kernels refused: {dict(DW_REFUSED)} [{card_info()}]")
    check(np.isfinite(l_k) and abs(l_k - l_ref) <= loss_lim, f"darts loss {l_k} vs {l_ref}")
    check(abs(g_k - g_ref) <= 2e-2 * g_ref, f"darts grad_norm {g_k} vs {g_ref}")
    check(not DW_REFUSED, f"darts search: the kernels refused depthwise sites {dict(DW_REFUSED)}")
    fused = per_step["fused"]
    return {"ms": med, "rounds": ms, "profile": {r: {k: prof[r][k] for k in (
        "wall_ms", "device_ms", "idle_share", "launches", "by_kind_ms")} for r in prof},
            "launches_per_step": fused,
            "launches": {k: fused[0][k] + fused[1][k] for k in fused[0]}}


def phase_cdarts_stage() -> dict:
    """9x. `cli.search_cdarts.main` on the card at StageSearchConfig's width
    (3 layers of 2 cells, 4 nodes, C 16, aux pool 6; fp32, bs64 32x32
    synthetic), steps and iterations cut to 2 steps and 1 iteration a layer:
    the JSON parses with 3 final genotypes and 3 history entries;
    cdarts_retrain_imagenet builds from its final genotypes and runs a bf16
    forward; seconds a pretrain, joint and super-weight step and a
    discretization (medians). Then one fp32 joint step of the full-width
    controller (B=2, layer_idx 1, TF32 off) on seeded weights against the
    JAX package's record (its step in float64): loss 1e-4, grad norm 1e-3
    relative, alpha grads 1e-2 of their largest (the port's fp32 on the CPU
    sits up to 1.7e-3 off: the batch of 2 puts BN-cancelled terms in
    them)."""
    import tempfile

    from cream_tpu_torch.cli import search_cdarts
    from cream_tpu_torch.nas import cdarts_stage as S
    from cream_tpu_torch.nas.cdarts import make_alpha_adam
    from cream_tpu_torch.train.optim import make_sgd
    no_tf32()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        t0 = time.perf_counter()
        res = search_cdarts.main(["--synthetic", "--batch-size", str(DARTS_BATCH), "--steps", "2",
                                  "--iters", "1", "--out", f"{tmp}/genotypes.json"])
        cli_s = time.perf_counter() - t0
        data = json.loads(Path(f"{tmp}/genotypes.json").read_text())
    check(len(data["final_genotypes"]) == 3 and len(data["history"]) == 3,
          f"search_cdarts JSON {len(data['final_genotypes'])} / {len(data['history'])}")
    m = create_model(RETRAIN, genotypes=data["final_genotypes"], device="cuda",
                     dtype=torch.bfloat16)
    m.load_state_dict(seeded_state_dict(m, 0))
    out = predict(m, smooth_images(torch.Generator("cuda").manual_seed(14), 2))
    check(out.shape == (2, 1000) and bool(torch.isfinite(out).all()), "retrain from the search")
    t = {k: statistics.median(v) for k, v in res["timings"].items()}
    g = np.load(DATA / "cdarts_joint_step_seed0.npz")
    ctrl = S.CDARTSController(RETRAIN_GENOTYPES, device="cuda")
    ctrl.load_state_dict(seeded_state_dict(ctrl, int(g["weight_seed"])))
    alphas = {k: torch.from_numpy(g[f"alphas/{k}"]).cuda() for k in
              ("normal", "reduce", "beta_normal", "beta_reduce")}
    nas_opt, alpha_opt = RecordingOpt(make_sgd(0.05)), RecordingOpt(make_alpha_adam())
    step = S.make_joint_search_step(ctrl, nas_opt, alpha_opt, 1.0, 2.0, "kl", 1e-3)
    loss, _ = step(alphas, {"image": torch.from_numpy(g["image"]).cuda(),
                            "label": torch.from_numpy(g["label"]).cuda()}, 1)
    l_err = abs(float(loss) - float(g["loss"]))
    gn = float(global_norm(nas_opt.grads.values()))
    gn_err = abs(gn - float(g["grad_norm"])) / float(g["grad_norm"])
    a_err = max(float(np.abs(alpha_opt.grads[k].cpu().numpy() - g[f"alpha_grad/{k}"]).max()
                      / np.abs(g[f"alpha_grad/{k}"]).max()) for k in alphas)
    print(f"cli.search_cdarts on the card (3 layers x 2 cells, 4 nodes, C 16, fp32 bs"
          f"{DARTS_BATCH}, 2 steps and 1 iteration a layer): {cli_s:.1f} s, final genotypes "
          f"{[gg['normal'][0] for gg in data['final_genotypes']]}, seconds a pretrain step "
          f"{t['pretrain']:.3f}, joint step {t['joint']:.3f}, super-weight step "
          f"{t['super_weight']:.3f}, discretization {t['discretize']:.3f} (medians); "
          f"{RETRAIN} from its genotypes bf16 B=2 finite; full-width joint step fp32 B=2 vs the "
          f"JAX record (float64): loss |diff| {l_err:.2e} (bound 1e-4), grad norm rel "
          f"{gn_err:.2e} (bound 1e-3), alpha grads max err / max |grad| {a_err:.2e} (bound 1e-2) "
          f"[{card_info()}]")
    check(l_err <= 1e-4 and gn_err <= 1e-3 and a_err <= 1e-2,
          f"joint step vs JAX {l_err} {gn_err} {a_err}")
    return {"cli_s": cli_s, "step_s": t}


def phase_nb201(steps: int = 10) -> dict:
    """9y. NAS-Bench-201: nasbench201_search (C 16, N 5) under
    CyclicSearcher in bf16 at bs64 32x32 (seeded alphas, SGD 0.05 / 0.9,
    Adam 3e-4): ms a weight + alpha step (CUDA events, `steps` after 2);
    nasbench201_infer on the example arch (every op): the fp32 B=2 logits
    against the JAX package's (1e-3), bf16 bs256 img/s (`throughput`)."""
    from cream_tpu_torch.models import nasbench201 as nb
    from cream_tpu_torch.nas.cdarts import CyclicSearcher
    no_tf32()
    dtype, gen = torch.bfloat16, torch.Generator("cuda").manual_seed(15)
    m = create_model("nasbench201_search", device="cuda", dtype=dtype)
    m.load_state_dict(seeded_state_dict(m, 0))
    s = CyclicSearcher(m, nb.init_alphas_201(torch.Generator("cuda").manual_seed(0),
                                             device="cuda"))
    b = {"image": smooth_images(gen, DARTS_BATCH, 32).to(dtype),
         "label": torch.randint(0, 10, (DARTS_BATCH,), generator=gen, device="cuda")}
    losses = [(s.weight_step(b), s.alpha_step(b)) for _ in range(2)]
    ms = timed_steps(lambda: (s.weight_step(b), s.alpha_step(b)), steps)
    g = np.load(DATA / "nasbench201_infer_seed0.npz")
    ref = create_model("nasbench201_infer", genotype=nb.EXAMPLE_ARCH, device="cuda")
    sd = seeded_state_dict(ref, int(g["weight_seed"]))
    ref.load_state_dict(sd)
    x = np.random.default_rng(int(g["input_seed"])).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)
    err = float(np.abs(predict(ref, torch.from_numpy(x)).cpu().numpy() - g["logits"]).max())
    bf = create_model("nasbench201_infer", genotype=nb.EXAMPLE_ARCH, device="cuda", dtype=dtype)
    bf.load_state_dict(sd)
    ips = throughput(bf, BATCH, 32, dtype, 20, 3)
    print(f"nasbench201_search bf16 B={DARTS_BATCH} under CyclicSearcher "
          f"(nasbench201_search_step_ms): {statistics.median(ms):.2f} ms a weight + alpha step "
          f"(median of {steps}, CUDA events; host-synchronized by the searcher's float losses), "
          f"first losses {losses[0]}, genotype {nb.structure_tostr(s.genotype())}; "
          f"nasbench201_infer {nb.EXAMPLE_ARCH}: fp32 B=2 vs JAX logits max_abs_err={err:.3e} "
          f"bound=1e-3, bf16 B={BATCH} {ips:.1f} img/s (nasbench201_infer_throughput) "
          f"[{card_info()}]")
    check(err <= 1e-3 and all(np.isfinite(losses).ravel()), f"nasbench201 {err} {losses}")
    return {"search_ms": statistics.median(ms), "infer_img_per_s": ips}


DET_BATCH, DET_CANVAS = 16, 512
# the PERF.md metric stem of each detector
DET_METRICS = {"retinanet_efficientvit_m4": "retinanet_m4_512",
               "mask_rcnn_efficientvit_m4": "mask_rcnn_m4_512"}
# the detectors' fp32 steps against JAX's float64 step (`check_step_golden`):
# per tensor 5e-3, as EfficientViT-M5's train golden (ReLU inputs within
# fp32 noise of 0 move some attention-BN and first-layer grads by ~1e-3
# under rounding alone; the port: up to 2.7e-3, on the CPU and the card).
# Mask R-CNN's RPN-sampled loss makes stage 0's attention q-BN grads
# (norms 0.03-0.04) cancelling sums: fp32 implementations spread 0.2-1.5%
# there (JAX's fp32 CPU 1.5%, the port's "fused" route on the card 1.4%,
# each run bit-stable), and the patch-embed grads that set the global norm
# 3-6e-4, so it also takes 1e-4 of the largest tensor's norm and 5e-4 on
# the global norm
DET_GRAD_TOLS = {"retinanet_efficientvit_m4": dict(per_tensor=5e-3),
                 "mask_rcnn_efficientvit_m4": dict(per_tensor=5e-3, grad_norm=5e-4,
                                                   of_largest=1e-4)}
RETINA_GOLDEN = DATA / "retinanet_efficientvit_m4_512_seed0.npz"
MRCNN_GOLDEN = DATA / "mask_rcnn_efficientvit_m4_512_seed0.npz"
# EfficientViT-M4's attention stages at canvas 512, bs16 (maps 32/16/8: 7x7
# windows, 25 an image with padding; 7x7, 9; 4x4, 4): (name, windows, ws,
# C, heads, kernels, blocks per forward)
DET_K4 = [("det_s0", DET_BATCH * 25, 7, 128, 4, (7, 5, 3, 3), 1),
          ("det_s1", DET_BATCH * 9, 7, 256, 4, (7, 5, 3, 3), 2),
          ("det_s2", DET_BATCH * 4, 4, 384, 4, (7, 5, 3, 3), 3)]


def det_dw_sites() -> list:
    """The detectors' backbone depthwise 3x3 site shapes in a train step at
    canvas 512, bs16 (`models.retinanet.dw3x3_sites`, traced on the meta
    device; each shape once), held to the plain versions in `phase_dw`."""
    from cream_tpu_torch.models.retinanet import dw3x3_sites as det_sites
    m = create_model("retinanet_efficientvit_m4", device="meta")
    shapes = list(dict.fromkeys(det_sites(m, DET_BATCH)))
    return [(f"det_m4_{i}", *shape, stride, 0) for i, (stride, shape) in enumerate(shapes)]


def det_images(seed: int, batch: int = 2, canvas: int = DET_CANVAS) -> torch.Tensor:
    """The goldens' N(0, 1) images from default_rng(seed), on the card."""
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (batch, canvas, canvas, 3)).astype(np.float32)).cuda()


def held(tag: str, got, want, rel: float = 1e-3) -> float:
    """|got - want| <= rel * max |want|; returns the error over that max."""
    got = got.detach().float().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    top = float(np.abs(want).max())
    err = float(np.abs(got - want).max()) / top
    check(got.shape == want.shape and bool(np.isfinite(got).all()), f"{tag}: shape or finite")
    check(err <= rel, f"{tag}: err {err:.3e} of the largest > {rel}")
    return err


def level_sums(t: torch.Tensor, levels) -> np.ndarray:
    """(B, A, ...) -> (B, L, ...) sums over each level's anchors (and, with
    classes, the classes), in float64."""
    t = t.detach().double().cpu().numpy()
    out, off = [], 0
    for n in levels:
        part = t[:, off:off + n]
        out.append(part.sum(axis=(1, 2)) if t.ndim == 3 and t.shape[-1] != 4 else part.sum(1))
        off += n
    return np.stack(out, axis=1)


def tie_free(scores: np.ndarray, tol: float = 1e-6) -> np.ndarray:
    """Per row: the entries no other entry of the row comes within tol of."""
    d = np.abs(scores[:, :, None] - scores[:, None, :])
    d[:, np.arange(scores.shape[1]), np.arange(scores.shape[1])] = np.inf
    return d.min(axis=2) > tol


def same_detections(tag: str, dets: list, g, id_key: str, gid: str) -> int:
    """Port detections against a golden's, rank for rank: the same id and
    label wherever the golden's score has no tie within 1e-6, boxes within
    1e-2 px there. Returns the number of ranks held."""
    free = tie_free(g["det_scores"])
    n = 0
    for i, d in enumerate(dets):
        check(len(d["scores"]) == g["det_scores"].shape[1], f"{tag}: {len(d['scores'])} dets")
        f = free[i]
        check(np.array_equal(d[id_key][f], g[gid][i][f])
              and np.array_equal(d["labels"][f], g["det_labels"][i][f]),
              f"{tag}: image {i}: other detections where the scores are tie-free")
        check(float(np.abs(d["boxes"][f] - g["det_boxes"][i][f]).max()) <= 1e-2,
              f"{tag}: image {i}: boxes")
        check(float(np.abs(d["scores"] - g["det_scores"][i]).max()) <= 1e-5, f"{tag}: scores")
        n += int(f.sum())
    return n


def det_step_grads(model, loss_fn, *args):
    """(loss, metrics, grads by param name) of one train-mode step."""
    model.train()
    loss, metrics = loss_fn(model, *args)
    params = dict(model.named_parameters())
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    model.eval()
    return loss.detach(), metrics, grads


def phase_det_goldens() -> None:
    """9z1. RetinaNet-M4 and Mask R-CNN-M4 fp32 at canvas 512, B=2 (TF32
    off) on seeded weights against the JAX records in tests/data/torch_port/:
    outputs (per-level sums and seeded rows) within 1e-3 of their largest,
    6 fp32 K4 launches a forward; the decodes at score_thr 0 (RetinaNet's
    anchors, Mask R-CNN's rois on JAX's proposals) the same where the
    golden's scores are tie-free; one train step on "library" and on
    "fused" (the samplers fed JAX's sampled order) against JAX's float64
    step: each loss within 1e-4, the grad norms per `DET_GRAD_TOLS`
    (`check_step_golden`)."""
    from cream_tpu_torch.cli.train_mask_rcnn import synthetic_targets
    from cream_tpu_torch.cli.train_retinanet import retinanet_step_loss, synthetic_boxes
    from cream_tpu_torch.models import mask_rcnn as MR
    from cream_tpu_torch.models import retinanet as RN
    no_tf32()
    card = card_info()
    # RetinaNet
    g = np.load(RETINA_GOLDEN)
    m = create_model("retinanet_efficientvit_m4", device="cuda")
    sd = seeded_state_dict(m, int(g["weight_seed"]))
    m.load_state_dict(sd)
    x = det_images(int(g["input_seed"]))
    levels = RN.anchors_per_level(DET_CANVAS)
    anchors = torch.from_numpy(RN.retina_anchors(DET_CANVAS)).cuda()
    n0 = cga.LAUNCHES
    with torch.inference_mode():
        cls, reg = m(x)
    check(cga.LAUNCHES - n0 == 6, f"retinanet fp32: {cga.LAUNCHES - n0} K4 launches")
    rows = torch.from_numpy(g["rows"]).cuda()
    errs = [held("retinanet cls level sums", level_sums(cls, levels), g["cls_level_sums"]),
            held("retinanet reg level sums", level_sums(reg, levels), g["reg_level_sums"]),
            held("retinanet cls rows", cls[:, rows], g["cls_rows"]),
            held("retinanet reg rows", reg[:, rows], g["reg_rows"])]
    held_ranks = same_detections("retinanet decode", RN.retinanet_decode(
        cls, reg, anchors, levels, score_thr=0.0), g, "anchor", "det_anchor")
    print(f"golden retinanet_efficientvit_m4 fp32 B=2 canvas 512 vs JAX: level sums, rows "
          f"max err / max |want| {max(errs):.2e} (bound 1e-3); decode at score_thr 0: anchors "
          f"and labels equal at the {held_ranks} of 200 ranks whose golden score is tie-free "
          f"(1e-6) [{card}]")
    boxes, labels, valid, _ = synthetic_boxes(np.random.default_rng(int(g["target_seed"])), 2,
                                              DET_CANVAS, 32, 80)
    batch = {"image": x, "boxes": torch.from_numpy(boxes).cuda(),
             "labels": torch.from_numpy(labels).cuda(), "valid": torch.from_numpy(valid).cuda()}
    for route in ("library", "fused"):
        m.load_state_dict(sd)
        set_dw_kernel(m, route)
        loss, losses, grads = det_step_grads(m, retinanet_step_loss(anchors, 80), batch)
        for k in ("loss_cls", "loss_bbox"):
            e = abs(float(losses[k]) - float(g[k])) / abs(float(g[k]))
            check(e <= 1e-4, f"retinanet train golden ({route}) {k} rel err {e}")
        check(int(losses["num_pos"]) == int(g["num_pos"]), "retinanet train golden num_pos")
        check_step_golden(f"train golden retinanet_efficientvit_m4 ({route})", g, loss, grads,
                          **DET_GRAD_TOLS["retinanet_efficientvit_m4"])
    del m
    # Mask R-CNN
    g = np.load(MRCNN_GOLDEN)
    m = create_model("mask_rcnn_efficientvit_m4", device="cuda")
    sd = seeded_state_dict(m, int(g["weight_seed"]))
    m.load_state_dict(sd)
    x = det_images(int(g["input_seed"]))
    levels = MR.mask_rcnn_anchor_levels(DET_CANVAS)
    anchors = torch.from_numpy(MR.mask_rcnn_anchors(DET_CANVAS)).cuda()
    n0 = cga.LAUNCHES
    with torch.inference_mode():
        feats, rpn_cls, rpn_reg = m(x)
        check(cga.LAUNCHES - n0 == 6, f"mask_rcnn fp32: {cga.LAUNCHES - n0} K4 launches")
        rows = torch.from_numpy(g["rpn_rows"]).cuda()
        errs = [held("mask_rcnn rpn cls level sums", level_sums(rpn_cls[..., None], levels),
                     g["rpn_cls_level_sums"]),
                held("mask_rcnn rpn reg level sums", level_sums(rpn_reg, levels),
                     g["rpn_reg_level_sums"]),
                held("mask_rcnn rpn cls rows", rpn_cls[:, rows], g["rpn_cls_rows"]),
                held("mask_rcnn rpn reg rows", rpn_reg[:, rows], g["rpn_reg_rows"])]
        props, _ = MR.rpn_proposals(rpn_cls, rpn_reg, anchors, levels, DET_CANVAS,
                                    max_per_img=256)
        gp = torch.from_numpy(g["proposals"]).cuda()
        near = (props[:, :, None, :] - gp[:, None, :, :]).abs().amax(-1).amin(1) <= 0.05
        matched = float(near.float().mean())
        check(matched >= 0.99, f"mask_rcnn proposals: {matched:.4f} of JAX's matched")
        cls, reg = m.roi_bbox(feats, MR.rois_flat(gp))
        cls, reg = cls.reshape(2, 256, -1), reg.reshape(2, 256, -1, 4)
        rr = torch.from_numpy(g["roi_rows"]).cuda()
        errs += [held("mask_rcnn box head cls rows", cls[:, rr], g["roi_cls_rows"]),
                 held("mask_rcnn box head reg rows", reg[:, rr], g["roi_reg_rows"])]
        dets = MR.mask_rcnn_decode(cls, reg, gp, DET_CANVAS, score_thr=0.0)
        held_ranks = same_detections("mask_rcnn decode", dets, g, "roi_index", "det_roi_index")
        det_rois = torch.cat([torch.cat([torch.full((100, 1), float(i)),
                                         torch.from_numpy(g["det_boxes"][i])], 1)
                              for i in range(2)]).cuda()
        mlog = m.roi_mask(feats, det_rois).reshape(2, 100, 28, 28, -1).float().sum((2, 3))
        sums = torch.gather(mlog, 2, torch.from_numpy(g["det_labels"]).long().cuda()[..., None])
        errs.append(held("mask_rcnn mask head sums", sums[..., 0], g["det_mask_sums"]))
    print(f"golden mask_rcnn_efficientvit_m4 fp32 B=2 canvas 512 vs JAX: RPN level sums and "
          f"rows, the box head on JAX's proposals, the mask head's sums on JAX's detections: "
          f"max err / max |want| {max(errs):.2e} (bound 1e-3); proposals: {matched:.4f} of "
          f"JAX's within 0.05 px; decode: rois and labels equal at the {held_ranks} of 200 "
          f"tie-free ranks [{card}]")
    tgt = synthetic_targets(np.random.default_rng(int(g["target_seed"])), 2, DET_CANVAS,
                            int(g["max_boxes"]), 80)
    tgt = {k: torch.from_numpy(v).cuda() for k, v in tgt.items()}
    n_cand = int(g["max_boxes"]) + int(g["proposals_n"])
    u = {}
    for tag, n in (("rpn", len(anchors)), ("rcnn", n_cand)):
        u[tag] = torch.full((2, 2, n), 1e-30, device="cuda")
        for j, kind in enumerate(("pos", "neg")):
            u[tag][:, j].scatter_(1, torch.from_numpy(g[f"u_{tag}_{kind}_idx"]).long().cuda(),
                                  torch.from_numpy(g[f"u_{tag}_{kind}"]).cuda())

    def loss_fn(model):
        return MR.mask_rcnn_losses(model, x, tgt["boxes"], tgt["labels"], tgt["valid"],
                                   tgt["masks"], anchors, levels, u["rpn"], u["rcnn"],
                                   int(g["rpn_samples"]), int(g["rcnn_samples"]),
                                   int(g["proposals_n"]))
    for route in ("library", "fused"):
        m.load_state_dict(sd)
        set_dw_kernel(m, route)
        loss, losses, grads = det_step_grads(m, loss_fn)
        errs = {k: abs(float(losses[k]) - float(g[f"loss_{k}"])) / abs(float(g[f"loss_{k}"]))
                for k in ("rpn_cls", "rpn_reg", "cls", "reg", "mask")}
        print(f"train golden mask_rcnn_efficientvit_m4 ({route}): the five losses' rel errs "
              + ", ".join(f"{k} {e:.2e}" for k, e in errs.items()) + " (bound 1e-4), positives "
              f"{int(losses['num_pos'])} (JAX {int(g['loss_num_pos'])})")
        check(max(errs.values()) <= 1e-4, f"mask_rcnn train golden ({route}) losses {errs}")
        check(int(losses["num_pos"]) == int(g["loss_num_pos"]), "mask_rcnn train num_pos")
        check_step_golden(f"train golden mask_rcnn_efficientvit_m4 ({route})", g, loss, grads,
                          **DET_GRAD_TOLS["mask_rcnn_efficientvit_m4"])


def phase_det_k4(gen) -> tuple[float, dict]:
    """9z2. K4 against its plain version at EfficientViT-M4's stage shapes
    for a canvas-512 detector at bs16 (padded 7x7 windows over the 32x32
    map, 7x7 over 16x16, 4x4 over 8x8), bf16 (8 ulps; the same bits on two
    launches) and fp32; bf16 kernel, plain and unfused plain-route module
    times by CUDA-graph replay in 2 interleaved rounds, beside the bound,
    summed per forward."""
    worst, times = 0.0, {}
    for name, W, ws, C, heads, kernels, blocks in DET_K4:
        d = C // heads
        side = {25: 32, 9: 16, 4: 8}[W // DET_BATCH]
        for dtype in (torch.bfloat16, torch.float32):
            m = seeded_cga(C, heads, ws, kernels, dtype, seed=C + ws)
            fmap = torch.randn(DET_BATCH, side, side, C, generator=gen, device="cuda").to(dtype)
            x = window_partition(fmap, ws)[0].reshape(W, ws, ws, C).contiguous()
            kw = dict(ws=ws, heads=heads, c_in=d, kd=KD, d=d, ks_max=m.ks_max)
            ops = (m.attention_biases, m.attention_bias_idxs, *m.folded())
            with torch.inference_mode():
                out = cga.fused_cga(x, *ops, **kw)
                again = cga.fused_cga(x, *ops, **kw)
                torch.cuda.synchronize()
                ref = cga.fused_cga_ref(x, *ops, **kw)
            err = (out.float() - ref.float()).abs().max().item()
            lim = k4_bound(dtype, ref.float())
            print(f"k4 {name} (detector, canvas 512) W={W} ws={ws} C={C} "
                  f"{str(dtype).split('.')[-1]}: max_abs_err={err:.3e} bound={lim:.3e}; two "
                  f"launches bit-identical: {torch.equal(out, again)}")
            check(err <= lim, f"K4 {name} {dtype} err {err} > {lim}")
            if dtype != torch.bfloat16:
                continue
            check(torch.equal(out, again), f"K4 {name}: other bits on a second launch")
            worst = max(worst, err)
            m.attn_kernel = "plain"
            with torch.inference_mode():
                k_ms, p_ms, u_ms = interleaved_graph_ms(lambda: cga.fused_cga(x, *ops, **kw),
                                                        lambda: cga.fused_cga_ref(x, *ops, **kw),
                                                        lambda: m(x))
            t = dict(ms=k_ms, plain_ms=p_ms, module_ms=u_ms, per_forward=blocks)
            t["bound_ms"], t["bound_by"] = k4_bound_ms(W, ws, C, heads, kernels, dtype)
            times[name] = t
            print(f"k4 time {name} bf16 W={W} (device, CUDA graph, median of {GRAPH_ROUNDS} interleaved "
                  f"rounds): kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, unfused module "
                  f"{u_ms:.4f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}) "
                  f"[{card_info()}]")
    tot = {k: sum(t[k] * t["per_forward"] for t in times.values())
           for k in ("ms", "plain_ms", "module_ms", "bound_ms")}
    print(f"k4 per EfficientViT-M4 backbone forward at canvas 512 bf16 bs{DET_BATCH}: kernel "
          f"{tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f}, unfused module "
          f"{tot['module_ms']:.4f}, bound {tot['bound_ms']:.4f} ms [{card_info()}]")
    return worst, tot


def forward_flops(model, images: torch.Tensor) -> float:
    """FLOPs of one eval forward (convolutions and matmuls, as
    torch.utils.flop_counter counts them) on the "plain" attention route,
    whose products are library calls; the model's route is restored."""
    from torch.utils.flop_counter import FlopCounterMode
    route = next(m.attn_kernel for m in model.modules() if isinstance(m, CascadedGroupAttention))
    model.backbone.set_attn_kernel("plain")
    with torch.inference_mode(), FlopCounterMode(display=False) as fc:
        model(images)
    model.backbone.set_attn_kernel(route)
    return float(fc.get_total_flops())


def outputs_of(out) -> list[torch.Tensor]:
    return [t for o in out for t in (o if isinstance(o, (tuple, list)) else (o,))]


def phase_det_eval(name: str, batch: int = DET_BATCH) -> dict:
    """9z3. A detector's eval main path at bf16 bs16, canvas 512: the
    "cascade" outputs within 8 bf16 ulps of "plain" (6 K4 launches a
    forward); forward and forward + decode img/s (`speed_test.
    detector_throughput`, the host's NMS included; K4 launches of the whole
    run 6 a forward), peak memory, device time by kind and idle share
    (`profile_step.profile`), the forward's FLOPs against the bf16 peak."""
    from cream_tpu_torch.cli.profile_step import profile
    from cream_tpu_torch.cli.speed_test import (detector_batch, detector_forward_fn,
                                                detector_throughput)
    dtype, card = torch.bfloat16, card_info()
    m = create_model(name, device="cuda", dtype=dtype)
    m.load_state_dict(seeded_state_dict(m, 0))
    x = detector_batch(m, batch, dtype)["image"]
    m.backbone.set_attn_kernel("plain")
    with torch.inference_mode():
        ref = outputs_of(m(x))
    m.backbone.set_attn_kernel("cascade")
    cga.LAUNCHES = 0
    dwconv.reset_launches()
    with torch.inference_mode():
        got = outputs_of(m(x))
    per_forward = cga.LAUNCHES
    check(per_forward == 6, f"{name}: {per_forward} K4 launches a forward")
    errs = [(a.float() - b.float()).abs().max().item() / bf16_ulp(b.float().abs().max()).item()
            for a, b in zip(got, ref)]
    check(all(bool(torch.isfinite(t).all()) for t in got), f"{name}: outputs not finite")
    check(max(errs) <= 8, f"{name}: cascade vs plain {max(errs):.2f} bf16 ulps")
    ips = detector_throughput(m, batch, dtype, False, 10, 3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ips_dec = detector_throughput(m, batch, dtype, True, 10, 3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    runs = 1 + 2 * 13
    check(cga.LAUNCHES == runs * 6, f"{name}: {cga.LAUNCHES} K4 launches in the eval main path")
    prof = profile(detector_forward_fn(m, x, decode=True), steps=3, warmup=2, top=8)
    flops = forward_flops(m, x[:1]) * batch
    bound = flops / PEAK_FLOPS[dtype] * 1e3
    kinds = ", ".join(f"{k} {v:.2f}" for k, v in list(prof["by_kind_ms"].items())[:8])
    metric = DET_METRICS[name]
    print(f"main {name} bf16 B={batch} canvas {DET_CANVAS}: cascade vs plain outputs within "
          f"{max(errs):.2f} bf16 ulps (bound 8), K4 launches a forward {per_forward}; "
          f"({metric}_infer_throughput) forward {ips:.1f} img/s, forward + decode {ips_dec:.1f} "
          f"img/s (CUDA events, 10 after 3; the host's NMS included), peak memory {peak:.2f} GiB; "
          f"forward {flops / batch / 1e9:.1f} GFLOP an image, bf16-peak bound "
          f"{bound:.3f} ms a bs{batch} forward against {batch / ips * 1e3:.3f} ms measured; "
          f"profile of forward + decode: wall {prof['wall_ms']:.2f} ms, device "
          f"{prof['device_ms']:.2f} ms, idle share {prof['idle_share']:.3f}, "
          f"{prof['launches']:.0f} launches; device ms by kind: {kinds} [{card}]")
    return {"img_per_s": ips, "decode_img_per_s": ips_dec, "peak_gib": peak,
            "k4_launches": cga.LAUNCHES, "gflop_per_image": flops / batch / 1e9,
            "bound_ms": bound, **{k: prof[k] for k in ("wall_ms", "device_ms", "idle_share",
                                                       "launches", "by_kind_ms")}}


def phase_det_train(name: str, batch: int = DET_BATCH, steps: int = 20) -> dict:
    """9z4. A detector's train main path at bf16 bs16 (fp32 params), canvas
    512, through `speed_test.detector_train_step_fn` (the CLIs' step): on
    "fused" K7/K9 launch at every site `models.retinanet.dw3x3_step_launches`
    counts, none refused, none on "library"; train img/s on "library" and
    "fused" in 2 interleaved rounds (CUDA events, 4 steps after 1), peak
    memory; first `steps` steps on one batch on "fused" from the seeded
    weights: the loss falls, every loss finite; device time and idle share
    of a step (`profile`)."""
    from cream_tpu_torch.cli.profile_step import profile
    from cream_tpu_torch.cli.speed_test import detector_train_step_fn, timed_images_per_s
    from cream_tpu_torch.models.retinanet import dw3x3_step_launches
    dtype, card = torch.bfloat16, card_info()
    runs, launches, ips, peak = {}, {}, {r: [] for r in ("library", "fused")}, {}
    DW_REFUSED.clear()
    for route in ("library", "fused"):
        m = create_model(name, device="cuda", dtype=dtype)
        m.load_state_dict(seeded_state_dict(m, 0))
        set_dw_kernel(m, route)
        _, runs[route] = detector_train_step_fn(m, batch, dtype)
        dwconv.reset_launches()
        first = runs[route]()
        torch.cuda.synchronize()
        launches[route] = dict(dwconv.LAUNCHES)
    want = dw3x3_step_launches(m, batch)
    check(launches["fused"] == want and sum(launches["library"].values()) == 0,
          f"{name}: K7/K9 launches a step {launches}, want {want} on fused")
    check(not DW_REFUSED, f"{name}: the kernels refused depthwise sites {dict(DW_REFUSED)}")
    n0 = dict(dwconv.LAUNCHES)
    history = [runs["fused"]() for _ in range(steps - 1)]
    torch.cuda.synchronize()
    losses = [float(h[0]) for h in [first] + history]
    parts = {k: [float(h[1][k]) for h in [first] + history] for k in first[1]
             if k not in ("num_pos", "grad_norm")}
    per_step = {k: (dwconv.LAUNCHES[k] - n0[k]) // (steps - 1) for k in n0}
    for r in range(1):
        for route in (("library", "fused") if r % 2 == 0 else ("fused", "library")):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ips[route].append(timed_images_per_s(runs[route], batch, 4, 1))
            peak[route] = torch.cuda.max_memory_allocated() / 2 ** 30
    prof = profile(runs["fused"], steps=3, warmup=1, top=8)
    kinds = ", ".join(f"{k} {v:.2f}" for k, v in list(prof["by_kind_ms"].items())[:8])
    metric = DET_METRICS[name]
    print(f"train {name} bf16 B={batch} canvas {DET_CANVAS} ({metric}_train_throughput): "
          + "; ".join(f"{r} " + " / ".join(f"{v:.1f}" for v in ips[r]) + f" img/s (peak "
                      f"{peak[r]:.2f} GiB)" for r in ips)
          + f" (one round, CUDA events, 4 steps after 1); fused K7/K9 launches a "
          f"step {per_step} (want {want}); loss over {steps} steps on one batch "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; profile (fused): wall {prof['wall_ms']:.2f} ms, "
          f"device {prof['device_ms']:.2f} ms a step, idle share {prof['idle_share']:.3f}, "
          f"{prof['launches']:.0f} launches; device ms by kind: {kinds} [{card}]")
    check(per_step == want, f"{name}: {per_step} K7/K9 launches a step in the {steps} steps")
    check(all(np.isfinite(v).all() for v in parts.values()) and all(np.isfinite(losses)),
          f"{name}: a loss is not finite: {parts}")
    check(losses[-1] < losses[0], f"{name}: train loss did not fall: {losses}")
    # every fused launch since that route's first step (the library route's are none)
    return {"img_per_s": ips, "peak_gib": peak, "losses": losses, "per_step": want,
            "main_path_launches": dict(dwconv.LAUNCHES),
            **{k: prof[k] for k in ("wall_ms", "device_ms", "idle_share", "launches",
                                    "by_kind_ms")}}


def phase_det_clis() -> dict:
    """9z5. Both detection CLIs' main(argv) on the card, --synthetic, with
    the M4 detectors at canvas 512 (B=2, 4 fp32 steps; Mask R-CNN at the
    CLI's sampler sizes): the loss finite, the native COCO AP of the decoded
    synthetic boxes (bbox, and segm for Mask R-CNN) computed."""
    from cream_tpu_torch.cli import train_mask_rcnn, train_retinanet
    out_dir = ROOT / "build" / "det_clis"
    out_dir.mkdir(parents=True, exist_ok=True)
    res = {}
    for cli, model, key in ((train_retinanet, "retinanet_efficientvit_m4", "AP"),
                            (train_mask_rcnn, "mask_rcnn_efficientvit_m4", "segm_AP")):
        t0 = time.time()
        r = cli.main(["--synthetic", "--model", model, "--canvas", str(DET_CANVAS),
                      "--batch-size", "2", "--steps", "4", "--out", str(out_dir / f"{model}.json")])
        h = r["history"]
        res[model] = {"losses": [x["total"] for x in h], "metrics": r["metrics"],
                      "s": time.time() - t0}
        print(f"cli {cli.__name__.split('.')[-1]} --synthetic --model {model} on cuda: losses "
              f"{[round(x['total'], 4) for x in h]}, native AP {r['metrics']} in "
              f"{res[model]['s']:.1f} s")
        check(all(np.isfinite(x["total"]) for x in h) and key in r["metrics"],
              f"{model} CLI: {h[-1]}")
    return res


DETR_NAME, DETR_RPE, DETR_BATCH = "detr_resnet50", "rpe-2.0-product-ctx-1-k", 16
DETR_GOLDEN = DATA / "detr_resnet50_irpe_k_seed0.npz"
DETR_GOLDEN_HW, DETR_QUERY_STD = (160, 224), 30.0
SEG_NAME, SEG_BATCH = "cydas_seg", 12
SEG_GOLDEN = DATA / "cydas_seg_seed0.npz"


def phase_rn_pool_grad() -> float:
    """9z6. A CLIP RN50 tower block that avg-pools (layer2's first, stride
    2), fp32: its input grad on the card against the CPU's (TF32 off)."""
    from cream_tpu_torch.models.resnet import CLIPBottleneck
    no_tf32()
    blk = CLIPBottleneck(256, 128, 2, dtype=torch.float32)
    blk.load_state_dict(seeded_state_dict(blk, 0))
    x = torch.randn(4, 56, 56, 256, generator=torch.Generator().manual_seed(1))
    grads = []
    for device in ("cpu", "cuda"):
        blk.to(device)
        xi = x.to(device).requires_grad_()
        y = blk(xi)
        gy = torch.linspace(-1, 1, y.numel(), device=device).reshape(y.shape)
        grads.append(torch.autograd.grad((y * gy).sum(), [xi])[0].cpu())
    err = float((grads[1] - grads[0]).abs().max() / grads[0].abs().max())
    print(f"rn pool repair: CLIP RN50 layer2.0 (stride 2) fp32 B=4 56x56 input grad on the "
          f"card vs the CPU: max err / max |grad| {err:.2e} (bound 1e-5) [{card_info()}]")
    check(err <= 1e-5, f"RN tower input grad on the card: err {err}")
    return err


def detr_golden_weights(model, seed: int) -> dict:
    """The DETR golden's weights: `seeded_state_dict` with the query
    embedding N(0, 30²) from default_rng(seed + 1), so every output's
    Hungarian matching is tie-free (tests/test_torch_detr.py)."""
    sd = seeded_state_dict(model, seed)
    shape = tuple(sd["query_embed.weight"].shape)
    sd["query_embed.weight"] = torch.from_numpy((DETR_QUERY_STD * np.random.default_rng(
        seed + 1).standard_normal(shape)).astype(np.float32))
    return sd


def detr_golden_batch(g) -> dict:
    """The golden's padded batch (image 0 padded below row 0.8 H, image 1
    right of column 0.75 W) and its targets, on the card."""
    from cream_tpu_torch.cli.train_detr import synthetic_targets
    h, w = DETR_GOLDEN_HW
    x = np.random.default_rng(int(g["input_seed"])).standard_normal(
        (2, h, w, 3)).astype(np.float32)
    mask = np.zeros((2, h, w), bool)
    mask[0, int(0.8 * h) + 1:] = True
    mask[1, :, int(0.75 * w) + 3:] = True
    x[mask] = 0.0
    boxes, labels, valid = synthetic_targets(np.random.default_rng(int(g["target_seed"])), 2,
                                             8, 91)
    t = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
    return {"image": t(x), "pad_mask": t(mask), "boxes": t(boxes),
            "labels": t(labels.astype(np.int32)), "valid": t(valid)}


def phase_detr_golden() -> None:
    """9z7. DETR-R50 iRPE-K and DETR-R18 fp32 (TF32 off) against the JAX
    record; one DETR-R50 iRPE-K fp32 step against JAX's float64 step."""
    from cream_tpu_torch.train.detection import criterion, hungarian_assign, matching_cost
    no_tf32()
    g = np.load(DETR_GOLDEN)
    b = detr_golden_batch(g)
    rows = torch.from_numpy(g["rows"]).cuda()
    errs = []
    for name, spec in ((DETR_NAME, DETR_RPE), ("detr_resnet18", "")):
        m = create_model(name, enc_rpe2d=spec, aux_loss=True, device="cuda")
        m.load_state_dict(detr_golden_weights(m, int(g["weight_seed"])))
        with torch.inference_mode():
            out = m(b["image"], b["pad_mask"])
        tag = name.split("_")[1]
        aux = out["aux_outputs"]
        errs += [held(f"{name} logits", out["pred_logits"], g[f"{tag}_logits"]),
                 held(f"{name} boxes", out["pred_boxes"], g[f"{tag}_boxes"]),
                 held(f"{name} aux logits", torch.stack([a["pred_logits"][:, rows] for a in aux]),
                      g[f"{tag}_aux_logits_rows"]),
                 held(f"{name} aux boxes", torch.stack([a["pred_boxes"][:, rows] for a in aux]),
                      g[f"{tag}_aux_boxes_rows"])]
    print(f"golden detr_resnet50 (iRPE-K) and detr_resnet18 fp32 B=2 160x224 (padded) vs JAX: "
          f"final and auxiliary logits and boxes max err / max |want| {max(errs):.2e} (bound "
          f"1e-3) [{card_info()}]")
    m = create_model(DETR_NAME, enc_rpe2d=DETR_RPE, aux_loss=True, device="cuda")
    m.load_state_dict(detr_golden_weights(m, int(g["weight_seed"])))
    m.train()
    out = m(b["image"], b["pad_mask"])
    valid = b["valid"].cpu().numpy()
    for i, o in enumerate([out] + out["aux_outputs"]):
        with torch.no_grad():
            c = matching_cost(o["pred_logits"], o["pred_boxes"], b["boxes"], b["labels"],
                              b["valid"])
        check(np.array_equal(hungarian_assign(c.cpu().numpy(), valid), g["assigns"][i]),
              f"DETR train golden: output {i}'s assignment differs from JAX's")
    losses = criterion(out, b["boxes"], b["labels"], b["valid"], 91)
    params = dict(m.named_parameters())
    grads = dict(zip(params, torch.autograd.grad(losses["total"], list(params.values()))))
    m.eval()
    for k in ("loss_ce", "loss_bbox", "loss_giou"):
        e = abs(float(losses[k].detach()) - float(g[k])) / abs(float(g[k]))
        check(e <= 1e-4, f"DETR train golden {k} rel err {e}")
    check_step_golden("train golden detr_resnet50 iRPE-K (six assignments equal JAX's)", g,
                      losses["total"].detach(), grads)


def flops_of(fn) -> float:
    """FLOPs of one call of `fn` (convolutions and matmuls, as
    torch.utils.flop_counter counts them)."""
    from torch.utils.flop_counter import FlopCounterMode
    with torch.inference_mode(), FlopCounterMode(display=False) as fc:
        fn()
    return float(fc.get_total_flops())


def phase_detr_eval(batch: int = DETR_BATCH) -> dict:
    """9z8. DETR-R50 iRPE-K's eval main path at bf16 bs16, canvas 512, each
    image with a seeded pixel mask (`speed_test.detr_batch`)."""
    from cream_tpu_torch.cli.profile_step import profile
    from cream_tpu_torch.cli.speed_test import (detector_forward_fn, detector_throughput,
                                                detr_batch)
    no_tf32()
    dtype, card = torch.bfloat16, card_info()
    m = create_model(DETR_NAME, enc_rpe2d=DETR_RPE, aux_loss=True, device="cuda", dtype=dtype)
    sd = seeded_state_dict(m, 0)
    m.load_state_dict(sd)
    b = detr_batch(m, batch, dtype)
    ips = detector_throughput(m, batch, dtype, False, 10, 3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ips_dec = detector_throughput(m, batch, dtype, True, 10, 3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    prof = profile(detector_forward_fn(m, b["image"], True, b["pad_mask"]), steps=3, warmup=2,
                   top=8)
    flops = flops_of(lambda: m(b["image"][:1], b["pad_mask"][:1])) * batch
    bound = flops / PEAK_FLOPS[dtype] * 1e3
    with torch.inference_mode():
        lo16 = m(b["image"], b["pad_mask"])["pred_logits"]
    ref = create_model(DETR_NAME, enc_rpe2d=DETR_RPE, aux_loss=True, device="cuda")
    ref.load_state_dict(sd)
    with torch.inference_mode():
        lo32 = ref(b["image"].float(), b["pad_mask"])["pred_logits"]
    del ref
    agree, decided, agree_decided = top1_agreement(lo16.float().flatten(0, 1),
                                                   lo32.flatten(0, 1))
    n_decided = round(decided * lo32.shape[0] * lo32.shape[1])
    kinds = ", ".join(f"{k} {v:.2f}" for k, v in list(prof["by_kind_ms"].items())[:8])
    print(f"main {DETR_NAME} iRPE-K bf16 B={batch} canvas 512, padded "
          f"(detr_r50_irpe_512_infer_throughput): forward {ips:.1f} img/s, forward + "
          f"post_process {ips_dec:.1f} img/s (CUDA events, 10 after 3), peak memory {peak:.2f} "
          f"GiB; forward {flops / batch / 1e9:.1f} GFLOP an image, bf16-peak bound "
          f"{bound:.3f} ms a batch against {batch / ips * 1e3:.3f} ms measured; profile of "
          f"forward + post_process: wall {prof['wall_ms']:.2f} ms, device "
          f"{prof['device_ms']:.2f} ms, idle share {prof['idle_share']:.3f}, "
          f"{prof['launches']:.0f} launches; device ms by kind: {kinds}; bf16 vs fp32 top class "
          f"per query {agree:.4f} over {lo32.shape[0] * lo32.shape[1]}, {agree_decided:.4f} on "
          f"the {n_decided} whose fp32 top-2 margin is above 4 bf16 ulps (need >= 0.99) [{card}]")
    check(bool(torch.isfinite(lo16).all()), "DETR bf16 logits not finite")
    check(n_decided >= 100 and agree_decided >= 0.99,
          f"DETR bf16 vs fp32 top class {agree_decided} on {n_decided} decided queries")
    return {"img_per_s": ips, "decode_img_per_s": ips_dec, "peak_gib": peak,
            "gflop_per_image": flops / batch / 1e9, "bound_ms": bound,
            "agree_decided": agree_decided, **{k: prof[k] for k in (
                "wall_ms", "device_ms", "idle_share", "launches", "by_kind_ms")}}


def phase_detr_train(batch: int = DETR_BATCH, steps: int = 20) -> dict:
    """9z9. DETR-R50 iRPE-K's train main path: the CLI's step
    (`speed_test.detector_train_step_fn`) at bf16 bs16, canvas 512."""
    from cream_tpu_torch.cli.profile_step import profile
    from cream_tpu_torch.cli.speed_test import detector_train_step_fn, timed_images_per_s
    dtype, card = torch.bfloat16, card_info()
    m = create_model(DETR_NAME, enc_rpe2d=DETR_RPE, aux_loss=True, device="cuda", dtype=dtype)
    m.load_state_dict(seeded_state_dict(m, 0))
    _, run = detector_train_step_fn(m, batch, dtype)
    hist = [run() for _ in range(steps)]
    losses = [float(h[0]) for h in hist]
    parts = {k: [float(h[1][k]) for h in hist] for k in ("loss_ce", "loss_bbox", "loss_giou")}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ips = [timed_images_per_s(run, batch, 4, 1)]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    prof = profile(run, steps=3, warmup=1, top=8)
    kinds = ", ".join(f"{k} {v:.2f}" for k, v in list(prof["by_kind_ms"].items())[:8])
    print(f"train {DETR_NAME} iRPE-K bf16 B={batch} canvas 512 "
          f"(detr_r50_irpe_512_train_throughput): " + " / ".join(f"{v:.1f}" for v in ips)
          + f" img/s (one round, CUDA events, 4 steps after 1), peak memory {peak:.2f} GiB; loss "
          f"over {steps} steps on one batch {losses[0]:.4f} -> {losses[-1]:.4f}; profile: wall "
          f"{prof['wall_ms']:.2f} ms, device {prof['device_ms']:.2f} ms a step, idle share "
          f"{prof['idle_share']:.3f}, {prof['launches']:.0f} launches; device ms by kind: "
          f"{kinds} [{card}]")
    check(all(np.isfinite(losses)) and all(np.isfinite(v).all() for v in parts.values()),
          f"DETR train: a loss is not finite: {losses}")
    check(losses[-1] < losses[0], f"DETR train loss did not fall: {losses}")
    return {"img_per_s": ips, "peak_gib": peak, "losses": losses, **{k: prof[k] for k in (
        "wall_ms", "device_ms", "idle_share", "launches", "by_kind_ms")}}


def seg_golden_inputs(g) -> tuple[torch.Tensor, torch.Tensor]:
    from cream_tpu_torch.data.segmentation import synthetic_seg_batches
    hw = tuple(int(v) for v in g["hw"])
    x = np.random.default_rng(int(g["input_seed"])).standard_normal((2, *hw, 3)).astype(
        np.float32)
    lab = next(synthetic_seg_batches(2, hw, 19, 1, int(g["label_seed"])))["label"]
    return torch.from_numpy(x).cuda(), torch.from_numpy(lab).cuda()


def phase_cydas_golden() -> None:
    """9z10. cydas_seg fp32 (TF32 off) against the JAX record: the eval
    output and the three heads' per-class sums and seeded pixels (1e-3);
    one train step on "library" and "fused" against JAX's float64 step."""
    from cream_tpu_torch.train.segmentation import cydas_seg_loss
    no_tf32()
    g = np.load(SEG_GOLDEN)
    x, lab = seg_golden_inputs(g)
    m = create_model(SEG_NAME, device="cuda")
    sd = seeded_state_dict(m, int(g["weight_seed"]))
    m.load_state_dict(sd)
    with torch.inference_mode():
        aux = torch.stack(m(x, aux=True), 1)
    px = torch.from_numpy(g["pixels"]).cuda()
    errs = [held("cydas head sums", aux.double().sum((2, 3)), g["head_sums"]),
            held("cydas head pixels", aux[:, :, px[:, 0], px[:, 1]], g["head_pixels"])]
    print(f"golden cydas_seg fp32 B=2 97x129 vs JAX: eval output and the three heads' "
          f"per-class sums and seeded pixels max err / max |want| {max(errs):.2e} (bound 1e-3) "
          f"[{card_info()}]")
    for route in ("library", "fused"):
        m.load_state_dict(sd)
        set_dw_kernel(m, route)
        m.train()
        loss, parts = cydas_seg_loss(m(x), lab, int(g["min_kept"]))
        params = dict(m.named_parameters())
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        m.eval()
        for k in ("loss8", "loss16", "loss32"):
            e = abs(float(parts[k]) - float(g[k])) / float(g[k])
            check(e <= 1e-4, f"cydas train golden ({route}) {k} rel err {e}")
        check_step_golden(f"train golden cydas_seg ({route})", g, loss.detach(), grads)


def phase_cydas_eval(batch: int = SEG_BATCH) -> dict:
    """9z11. CyDAS's eval main path at bf16 bs12 on whole 1024 x 2048
    frames (`speed_test.seg_throughput`)."""
    from cream_tpu_torch.cli.profile_step import profile
    from cream_tpu_torch.cli.speed_test import (SEG_EVAL_HW, seg_batch, seg_forward_fn,
                                                seg_throughput)
    no_tf32()
    dtype, card = torch.bfloat16, card_info()
    m = create_model(SEG_NAME, device="cuda", dtype=dtype)
    sd = seeded_state_dict(m, 0)
    m.load_state_dict(sd)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ips = seg_throughput(m, batch, SEG_EVAL_HW, dtype, 5, 2)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    x = seg_batch(m, batch, SEG_EVAL_HW, dtype)["image"]
    prof = profile(seg_forward_fn(m, x), steps=2, warmup=1, top=8)
    flops = flops_of(lambda: m(x[:1])) * batch
    bound = flops / PEAK_FLOPS[dtype] * 1e3
    with torch.inference_mode():
        lo16 = m(x[:2]).float()
    ref = create_model(SEG_NAME, device="cuda")
    ref.load_state_dict(sd)
    with torch.inference_mode():
        lo32 = ref(x[:2].float())
    del ref
    agree, decided, agree_decided = top1_agreement(lo16.reshape(-1, 19), lo32.reshape(-1, 19))
    n_decided = round(decided * lo32[..., 0].numel())
    kinds = ", ".join(f"{k} {v:.2f}" for k, v in list(prof["by_kind_ms"].items())[:8])
    print(f"main {SEG_NAME} bf16 B={batch} 1024x2048 (cydas_seg_1024x2048_infer_throughput): "
          f"{ips:.2f} img/s (CUDA events, 5 after 2), peak memory {peak:.2f} GiB; forward "
          f"{flops / batch / 1e9:.1f} GFLOP an image, bf16-peak bound {bound:.3f} ms a batch "
          f"against {batch / ips * 1e3:.3f} ms measured; profile: wall {prof['wall_ms']:.2f} ms, "
          f"device {prof['device_ms']:.2f} ms, idle share {prof['idle_share']:.3f}, "
          f"{prof['launches']:.0f} launches; device ms by kind: {kinds}; bf16 vs fp32 per-pixel "
          f"argmax (B=2) {agree:.4f}, {agree_decided:.4f} on the {n_decided} pixels whose fp32 "
          f"top-2 margin is above 4 bf16 ulps (need >= 0.99) [{card}]")
    check(bool(torch.isfinite(lo16).all()), "cydas bf16 logits not finite")
    check(n_decided >= 1000 and agree_decided >= 0.99,
          f"cydas bf16 vs fp32 argmax {agree_decided} on {n_decided} decided pixels")
    return {"img_per_s": ips, "peak_gib": peak, "gflop_per_image": flops / batch / 1e9,
            "bound_ms": bound, "agree_decided": agree_decided, **{k: prof[k] for k in (
                "wall_ms", "device_ms", "idle_share", "launches", "by_kind_ms")}}


def cydas_dw_sites() -> list:
    """CyDAS's depthwise 3x3 site shapes in a train step at bs12, crop 769
    (`models.cydas_seg.dw3x3_sites`), one each a step, held to the plain
    versions and timed in `phase_dw`."""
    from cream_tpu_torch.models.cydas_seg import dw3x3_sites as seg_sites
    return [(f"cydas_{i}", *shape, stride, 1)
            for i, (stride, shape) in enumerate(seg_sites(SEG_BATCH, 769, 769))]


def phase_cydas_train(batch: int = SEG_BATCH, steps: int = 20) -> dict:
    """9z12. CyDAS's train main path: the CLI's step
    (`speed_test.seg_train_step_fn`: three OHEM losses, SGD) at bf16 bs12,
    crop 769, on "library" and "fused"."""
    from cream_tpu_torch.cli.profile_step import profile
    from cream_tpu_torch.cli.speed_test import SEG_CROP, seg_train_step_fn, timed_images_per_s
    from cream_tpu_torch.models.cydas_seg import dw3x3_sites as seg_sites
    dtype, card = torch.bfloat16, card_info()
    hw = (SEG_CROP, SEG_CROP)
    runs, first, launches = {}, {}, {}
    DW_REFUSED.clear()
    for route in ("library", "fused"):
        m = create_model(SEG_NAME, device="cuda", dtype=dtype)
        m.load_state_dict(seeded_state_dict(m, 0))
        set_dw_kernel(m, route)
        _, runs[route] = seg_train_step_fn(m, batch, hw, dtype)
        dwconv.reset_launches()
        first[route] = runs[route]()
        torch.cuda.synchronize()
        launches[route] = dict(dwconv.LAUNCHES)
    n = sum(s == 1 for s, _ in seg_sites(batch, *hw))
    want = {"k7_fwd": n, "k7_bwd": n, "k8": 0, "k9_fwd": 0, "k9_bwd": 0}
    check(launches["fused"] == want and sum(launches["library"].values()) == 0,
          f"cydas: K7/K9 launches a step {launches}, want {want} on fused")
    check(not DW_REFUSED, f"cydas: the kernels refused depthwise sites {dict(DW_REFUSED)}")
    l_lib, l_fus = float(first["library"][0]), float(first["fused"][0])
    g_lib, g_fus = (float(first[r][1]["grad_norm"]) for r in ("library", "fused"))
    ulps = abs(l_fus - l_lib) / float(bf16_ulp(torch.tensor(l_lib)))
    print(f"cydas first step fused vs library: loss {l_fus:.6f} vs {l_lib:.6f} ({ulps:.2f} bf16 "
          f"ulps, bound 2), grad norm {g_fus:.5f} vs {g_lib:.5f} (rel "
          f"{abs(g_fus - g_lib) / g_lib:.2e}, bound 2e-2)")
    check(ulps <= 2 and abs(g_fus - g_lib) <= 0.02 * g_lib, "cydas fused vs library first step")
    n0 = dict(dwconv.LAUNCHES)
    hist = [first["fused"]] + [runs["fused"]() for _ in range(steps - 1)]
    torch.cuda.synchronize()
    losses = [float(h[0]) for h in hist]
    parts = {k: [float(h[1][k]) for h in hist] for k in ("loss8", "loss16", "loss32")}
    per_step = {k: (dwconv.LAUNCHES[k] - n0[k]) // (steps - 1) for k in n0}
    ips, peak = {r: [] for r in runs}, {}
    for r in range(1):
        for route in (("library", "fused") if r % 2 == 0 else ("fused", "library")):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ips[route].append(timed_images_per_s(runs[route], batch, 3, 1))
            peak[route] = torch.cuda.max_memory_allocated() / 2 ** 30
    prof = profile(runs["fused"], steps=2, warmup=1, top=8)
    kinds = ", ".join(f"{k} {v:.2f}" for k, v in list(prof["by_kind_ms"].items())[:10])
    print(f"train {SEG_NAME} bf16 B={batch} crop {SEG_CROP} (cydas_seg_769_train_throughput): "
          + "; ".join(f"{r} " + " / ".join(f"{v:.2f}" for v in ips[r]) + f" img/s (peak "
                      f"{peak[r]:.2f} GiB)" for r in ips)
          + f" (one round, CUDA events, 3 steps after 1); fused K7 launches a step "
          f"{per_step} (want {want}); loss over {steps} steps on one batch {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; profile (fused): wall {prof['wall_ms']:.2f} ms, device "
          f"{prof['device_ms']:.2f} ms a step, idle share {prof['idle_share']:.3f}, "
          f"{prof['launches']:.0f} launches; device ms by kind: {kinds} [{card}]")
    check(per_step == want, f"cydas: {per_step} K7 launches a step in the {steps} steps")
    check(all(np.isfinite(losses)) and all(np.isfinite(v).all() for v in parts.values()),
          f"cydas train: a loss is not finite {parts}")
    check(losses[-1] < losses[0], f"cydas train loss did not fall: {losses}")
    return {"img_per_s": ips, "peak_gib": peak, "losses": losses, "per_step": want,
            "main_path_launches": dict(dwconv.LAUNCHES),
            **{k: prof[k] for k in ("wall_ms", "device_ms", "idle_share", "launches",
                                    "by_kind_ms")}}


def phase_seg_clis() -> dict:
    """9z13. The DETR and segmentation CLIs' main(argv) on the card,
    --synthetic: the DETR CLI's narrow model (4 steps, 128 px, B=2) and
    cydas_seg at a 257 crop in bf16 on "fused" (4 steps, B=2)."""
    from cream_tpu_torch.cli import train_detr, train_seg
    out_dir = ROOT / "build" / "seg_clis"
    out_dir.mkdir(parents=True, exist_ok=True)
    res = {}
    for name, cli, argv, key in (
            ("train_detr", train_detr, ["--steps", "4", "--batch-size", "2", "--image-size",
                                        "128", "--num-classes", "8"], "total"),
            ("train_seg", train_seg, ["--steps", "4", "--crop", "257", "--batch-size", "2",
                                      "--dtype", "bfloat16", "--dw-kernel", "fused"], "loss")):
        t0 = time.time()
        r = cli.main(["--synthetic", *argv, "--out", str(out_dir / f"{name}.json")])
        vals = [h[key] for h in r["history"]]
        res[name] = {"losses": vals, "s": time.time() - t0}
        print(f"cli {name} --synthetic on cuda: losses {[round(v, 4) for v in vals]} in "
              f"{res[name]['s']:.1f} s")
        check(len(vals) == 4 and all(np.isfinite(vals)), f"{name} CLI: {vals}")
    return res


TRANSFORM_GOLDEN = DATA / "train_transform_seed0.npz"
# the generated folder: ImageNet's common sizes (W, H), 10 classes
FOLDER_SIZES = [(500, 375), (375, 500), (500, 333), (333, 500), (500, 500)]
FOLDER_CLASSES, FOLDER_TRAIN, FOLDER_VAL = 10, 768, 256


def phase_pixels() -> dict:
    """9z14. The seeded train recipe and the eval preprocessing on this
    host: every output of the stored golden (the JAX package's Pillow
    pixels: TrainAugConfig(), rand-m3-n2-mstd0.5 and the colour-jitter route
    for 4 seeds on 8 stored source images, and the eval resize + crop at
    224) reproduced bit for bit (sha256 of the float32 output), so a numpy
    or BLAS here that rounds otherwise fails; a BMP written here read back
    bit for bit; the port's transform ms an image at 500 x 375."""
    import hashlib
    import tempfile

    from cream_tpu_torch.data import det_aug, image_io, transforms

    g = np.load(TRANSFORM_GOLDEN)
    stored = dict(zip(g["keys"].tolist(), g["digests"].tolist()))
    recipes = json.loads(str(g["recipes"]))
    sources = [g[f"source{i}"] for i in range(len([k for k in g.files if k.startswith("source")]))]
    made = {name: det_aug.make_train_transform(det_aug.TrainAugConfig(**kw))
            for name, kw in recipes.items()}
    pp = transforms.eval_preprocess_config(224)
    bad = []
    for key, want in stored.items():
        name, i, *seed = key.split("/")
        src = sources[int(i)]
        out = (transforms.preprocess_pil(src, pp) if name == "eval"
               else made[name](src, int(seed[0])))
        if hashlib.sha256(np.ascontiguousarray(out).tobytes()).hexdigest() != want:
            bad.append(key)
    check(not bad, f"{len(bad)} of {len(stored)} stored transform outputs differ: {bad[:8]}")
    rng = np.random.default_rng(0)
    img = folder_image(rng, 500, 375)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        path = Path(tmp) / "x.bmp"
        image_io.write_bmp(path, img)
        back = image_io.read_rgb(str(path))
    check(back.dtype == np.uint8 and np.array_equal(back, img), "a BMP did not read back")
    t = made["default"]
    t0 = time.perf_counter()
    for seed in range(40):
        t(img, seed)
    ms = (time.perf_counter() - t0) * 1e3 / 40
    t0 = time.perf_counter()
    for _ in range(40):
        transforms.preprocess_pil(img, pp)
    eval_ms = (time.perf_counter() - t0) * 1e3 / 40
    print(f"pixels: {len(stored)} stored outputs of the JAX package's Pillow recipe and eval "
          f"preprocessing reproduced bit for bit; a BMP read back bit for bit; the port's "
          f"TrainAugConfig() transform {ms:.2f} ms an image, eval preprocessing "
          f"{eval_ms:.2f} ms, at 500x375 (one thread, the mean of 40)")
    return {"transform_ms": ms, "eval_ms": eval_ms}


def folder_image(rng, w: int, h: int) -> np.ndarray:
    """A uint8 (h, w, 3) image with work for every op of the recipe: a
    low-frequency colour field (a random 4 x 5 colour grid, bilinearly
    upsampled), a hard-edged rectangle, a darker half-plane and a little
    noise."""
    grid = rng.uniform(0, 255, (4, 5 * 3))
    wy = np.clip(1 - np.abs(np.linspace(0, 3, h)[:, None] - np.arange(4)), 0, None)
    wx = np.clip(1 - np.abs(np.linspace(0, 4, w)[:, None] - np.arange(5)), 0, None)
    img = np.matmul(wx[None], (wy @ grid).reshape(h, 5, 3))
    x0, y0 = int(rng.integers(0, w - w // 4)), int(rng.integers(0, h - h // 4))
    img[y0:y0 + h // 4, x0:x0 + w // 4] = rng.uniform(0, 255, 3)
    a, b = rng.normal(size=2)
    yy, xx = np.ogrid[:h, :w]
    img[(a * (xx - w / 2) + b * (yy - h / 2)) > 0] *= rng.uniform(0.4, 0.9)
    img += rng.normal(0, 4, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def write_folder(root: Path, n_train: int, n_val: int, seed: int = 0) -> dict:
    """An ImageNet-style folder under `root`: train/ and val/ with
    FOLDER_CLASSES class folders of BMPs, `n_train` and `n_val` images at
    sizes drawn from FOLDER_SIZES, each image from its own seed; 8 writer
    threads."""
    from concurrent.futures import ThreadPoolExecutor

    from cream_tpu_torch.data.image_io import write_bmp

    jobs = [(split, i) for split, n in (("train", n_train), ("val", n_val))
            for i in range(n)]
    for split in ("train", "val"):
        for c in range(FOLDER_CLASSES):
            (root / split / f"n{c:08d}").mkdir(parents=True)

    def write(job):
        split, i = job
        rng = np.random.default_rng([seed, split == "val", i])
        w, h = FOLDER_SIZES[int(rng.integers(len(FOLDER_SIZES)))]
        path = root / split / f"n{i % FOLDER_CLASSES:08d}" / f"{split}_{i:05d}.bmp"
        write_bmp(path, folder_image(rng, w, h))
        return path.stat().st_size

    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:
        nbytes = sum(pool.map(write, jobs))
    return {"images": len(jobs), "bytes": nbytes, "s": time.perf_counter() - t0}


class Cycle:
    """`reps` passes over `dataset` as one dataset: item i is the dataset's
    i % len(dataset), and a loader draws each pass its own aug seeds. It
    gives a steady rate a window longer than the generated folder (the
    passes after the first read warm files). Module-level, so the loaders
    pickle it to their workers."""

    def __init__(self, dataset, reps: int):
        self.dataset, self.reps = dataset, reps

    def __len__(self) -> int:
        return self.reps * len(self.dataset)

    def load(self, i: int):
        return self.dataset.load(i % len(self.dataset))

    def load_bytes(self, i: int):
        return self.dataset.load_bytes(i % len(self.dataset))


def phase_folder_loader(root: Path) -> dict:
    """9z15. The loaders alone on the generated folder (no card work):
    train_loader with the full default recipe (TrainAugConfig()) at bs256 and
    8 worker processes over two passes of the 768 train images (6 batches:
    img/s with the workers' start, and the steady rate over the 4 batches
    after the first 2, the window 9z16's steady train step is timed over;
    the workers speed up over their first batches), and eval_loader
    (resize + crop) at bs256 over the 256 val images; img/s beside the
    host's CPU count; the recipe alone on one image in 1, 2, 4 and 8
    threads (48 images each; the loaders' threads before they took
    processes)."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    from cream_tpu_torch.data.det_aug import TrainAugConfig, make_train_transform
    from cream_tpu_torch.data.imagenet import (ImageFolder, Workers, eval_loader,
                                               train_loader)

    train_ds, val_ds = ImageFolder(str(root / "train")), ImageFolder(str(root / "val"))
    check((len(train_ds), len(val_ds), len(train_ds.class_to_idx)) ==
          (FOLDER_TRAIN, FOLDER_VAL, FOLDER_CLASSES), "the generated folder's listing")
    with Workers(len, 2) as pool:   # the loaders' fork server starts once a process
        pool.map(["warm"])
    t0 = time.perf_counter()
    arrivals = [(time.perf_counter(), len(b["label"])) for b in train_loader(
        Cycle(train_ds, 2), BATCH, 0, 0, 224, 8,
        transform=make_train_transform(TrainAugConfig()))]
    n = sum(k for _, k in arrivals)
    train_s = arrivals[-1][0] - t0
    # after 2 batches: the workers warmed, the rate a long epoch sees
    steady, _ = steady_rate(arrivals, 2)
    batch_s = [b - a for a, b in zip([t0] + [t for t, _ in arrivals], [t for t, _ in arrivals])]
    t0 = time.perf_counter()
    m = sum(int((b["label"] >= 0).sum()) for b in eval_loader(val_ds, BATCH, 224,
                                                               num_workers=8))
    eval_s = time.perf_counter() - t0
    res = {"train_img_per_s": n / train_s, "steady_img_per_s": steady,
           "eval_img_per_s": m / eval_s, "cpus": os.cpu_count(), "threads": {}}
    # the recipe alone on one decoded image in 1, 2, 4 and 8 threads
    recipe = make_train_transform(TrainAugConfig())
    img = train_ds.load(0)[0]
    for threads in (1, 2, 4, 8):
        t0 = time.perf_counter()
        with ThreadPoolExecutor(threads) as pool:
            list(pool.map(lambda seed: recipe(img, seed), range(48)))
        res["threads"][threads] = 48 / (time.perf_counter() - t0)
    print(f"folder_loader_img_per_s: train_loader (TrainAugConfig(), bs{BATCH}, 8 worker "
          f"processes) {res['train_img_per_s']:.1f} img/s over {n} images, the workers' start "
          f"included; {res['steady_img_per_s']:.1f} steady (the {len(arrivals) - 2} batches "
          f"after 2; s a batch "
          + " ".join(f"{v:.2f}" for v in batch_s)
          + "); eval_loader "
          f"(resize + crop) "
          f"{res['eval_img_per_s']:.1f} img/s over {m}; no card work; os.cpu_count() "
          f"{res['cpus']}; the recipe alone on one {img.shape[1]}x{img.shape[0]} image in "
          f"1/2/4/8 threads: "
          + " / ".join(f"{v:.1f}" for v in res["threads"].values()) + " img/s")
    return res


def phase_folder_train(root: Path) -> dict:
    """9z16. main path (training from a folder): cli.train.main on the
    generated folder, TinyViT-21M-224 bf16 compute with fp32 params, bs256,
    the full default recipe (RandAugment rand-m9-mstd0.5-inc1, random
    erasing 0.25, mixup 0.8 / cutmix 1.0), one epoch of 3 steps, then its
    eval: 10 K1 + 10 K2 launches a step, every loss finite; the epoch's
    img/s from the loader's start to the last step's end. Then the folder's
    steady train img/s (tinyvit21m_224_folder_train_throughput): the same
    step fed by train_loader + prefetch over 2 passes of the train images
    (6 batches), timed by CUDA events over 3 steps after 2 (by then the
    batches that the prefetch queue held during the first steps are used
    up, and each step waits for the loader), and the idle share of the step
    after those (cli.profile_step.profile), beside the synthetic
    train img/s (cli.speed_test.train_throughput); peak memory and img/s
    with remat_stem off and on. Returns the main path's K1/K2 launches."""
    from cream_tpu_torch.cli import train as train_cli
    from cream_tpu_torch.cli.profile_step import profile
    from cream_tpu_torch.core.config import Config
    from cream_tpu_torch.data.imagenet import ImageFolder, prefetch, train_loader
    from cream_tpu_torch.data.mixup import mixup_cutmix

    starts, ends, per_step, losses = [], [], [], []
    real_step, real_loader = train_cli.make_train_step, train_cli.train_loader

    def make_step(**kw):
        step = real_step(**kw)

        def timed(state, batch, seed):
            k = (wa.LAUNCHES, wa.BWD_LAUNCHES)
            state, metrics = step(state, batch, seed)
            per_step.append((wa.LAUNCHES - k[0], wa.BWD_LAUNCHES - k[1]))
            losses.append(float(metrics["loss"]))
            ends.append(time.perf_counter())
            return state, metrics
        return timed

    def loader(*args, **kw):
        starts.append(time.perf_counter())
        return real_loader(*args, **kw)

    opts = ["model.name=tiny_vit_21m_224", "model.dtype=bfloat16", "data.dataset=imagenet",
            f"data.data_path={root}", f"data.batch_size={BATCH}", "data.num_workers=8",
            "aug.mixup=0.8", "aug.cutmix=1.0", "train.epochs=1", "train.warmup_epochs=0",
            "train.nan_budget=0",
            f"output={root / 'out'}"]
    train_cli.make_train_step, train_cli.train_loader = make_step, loader
    try:
        wa.LAUNCHES = wa.BWD_LAUNCHES = 0
        t0 = time.perf_counter()
        acc = train_cli.main(opts)
        wall = time.perf_counter() - t0
        launches = (wa.LAUNCHES, wa.BWD_LAUNCHES)
    finally:
        train_cli.make_train_step, train_cli.train_loader = real_step, real_loader
    steps = FOLDER_TRAIN // BATCH
    check(per_step == [(10, 10)] * steps, f"folder train: K1/K2 launches a step {per_step}")
    check(launches == (10 * (steps + 1), 10 * steps),
          f"folder train: {launches} K1/K2 launches, want 10 + 10 a step and 10 K1 for "
          f"the eval forward")
    check(all(np.isfinite(losses)), f"folder train: a loss is not finite: {losses}")
    epoch_ips = steps * BATCH / (ends[-1] - starts[0])

    dtype = torch.bfloat16
    peak, ips = {}, {}
    for remat in (False, True):
        model = create_model("tiny_vit_21m_224", device="cuda", dtype=dtype, remat_stem=remat)
        model.load_state_dict(seeded_state_dict(model, 0))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ips[remat] = train_throughput(model, BATCH, 224, dtype, 5, 2)
        peak[remat] = torch.cuda.max_memory_allocated() / 2 ** 30
        del model

    cfg = Config.from_yaml(None, opts)
    model = create_model("tiny_vit_21m_224", device="cuda", dtype=dtype)
    model.load_state_dict(seeded_state_dict(model, 0))
    state = TrainState(model, make_adamw(1e-3, weight_decay=0.05, clip_grad=5.0,
                                         params=dict(model.named_parameters())))
    step = make_train_step(loss_fn=soft_target_ce)
    ds = ImageFolder(str(root / "train"))
    recipe = train_cli.build_train_transform(cfg)
    passes, warm, timed_steps, profiled = 2, 2, 3, 1
    check(warm + timed_steps + profiled == passes * steps, "the steady window's batch count")
    batches = prefetch(train_loader(Cycle(ds, passes), BATCH, 0, 0, 224, 8, transform=recipe))
    mix_gen = torch.Generator().manual_seed(0)
    a = cfg.aug

    def folder_step():
        b = next(batches)
        images = torch.from_numpy(b["image"]).to("cuda", dtype)
        labels = torch.from_numpy(b["label"]).to("cuda")
        images, targets = mixup_cutmix(mix_gen, images, labels, 1000, a.mixup, a.cutmix,
                                       a.mixup_switch_prob, a.label_smoothing)
        step(state, {"image": images, "label": targets}, 0)

    for _ in range(warm):
        folder_step()
    torch.cuda.synchronize()
    window = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    window[0].record()
    marks = [time.perf_counter()]
    for _ in range(timed_steps):
        folder_step()
        marks.append(time.perf_counter())
    window[1].record()
    torch.cuda.synchronize()
    folder_ips = timed_steps * BATCH / (window[0].elapsed_time(window[1]) / 1e3)
    prof = profile(folder_step, steps=profiled, warmup=0, top=8)
    check(next(batches, None) is None, "the steady window left a batch of its loader")
    res = {"folder_img_per_s": folder_ips, "epoch_img_per_s": epoch_ips,
           "synthetic_img_per_s": ips[False],
           "remat_img_per_s": ips[True], "peak_gib": peak[False],
           "remat_peak_gib": peak[True], "losses": losses, "acc1": acc, "cli_s": wall,
           "launches": launches, **{k: prof[k] for k in ("wall_ms", "device_ms",
                                                          "idle_share")}}
    print(f"folder train (cli.train, tiny_vit_21m_224 bf16 bs{BATCH}, the full recipe with "
          f"mixup 0.8 / cutmix 1.0, {steps} steps + eval in {wall:.1f} s): K1/K2 launches a "
          f"step {per_step[0]}, losses {[round(v, 4) for v in losses]}; the {steps}-step "
          f"epoch {epoch_ips:.1f} img/s (the loader's start to the last step's end); "
          f"tinyvit21m_224_folder_train_throughput {folder_ips:.1f} img/s steady (CUDA events, "
          f"{timed_steps} steps after {warm}, the loader running; s a step "
          + " ".join(f"{b - a:.2f}" for a, b in zip(marks, marks[1:]))
          + f") vs synthetic {ips[False]:.1f} "
          f"img/s (train_throughput, 5 steps after 2); the {profiled} folder-fed steps after "
          f"those: wall {prof['wall_ms']:.1f} ms, device {prof['device_ms']:.1f} ms, idle "
          f"share {prof['idle_share']:.3f}; peak memory {peak[False]:.2f} GiB, with remat_stem "
          f"{peak[True]:.2f} GiB ({ips[True]:.1f} img/s) [{card_info()}]")
    check(peak[True] < peak[False], "remat_stem did not lower the peak memory")
    return res


def phase_folder_eval(root: Path) -> dict:
    """9z17. main path (eval from a folder): cli.eval.main on the generated
    val folder, TinyViT-21M-224 bf16 bs256, seeded weights written as a .pth
    and passed by --torch-ckpt: 10 K1 launches a forward, n = 256; img/s
    (the CLI's wall, the loader included)."""
    from cream_tpu_torch.cli import eval as eval_cli

    model = create_model("tiny_vit_21m_224", device="cpu")
    ckpt = root / "tiny_vit_21m_224_seed0.pth"
    torch.save(seeded_state_dict(model, 0), ckpt)
    del model
    wa.LAUNCHES = wa.BWD_LAUNCHES = 0
    acc = eval_cli.main(["model.name=tiny_vit_21m_224", "model.dtype=bfloat16",
                         "data.dataset=imagenet", f"data.data_path={root}",
                         f"data.batch_size={BATCH}", "data.num_workers=8",
                         "--torch-ckpt", str(ckpt)])
    launches = wa.LAUNCHES
    forwards = -(-FOLDER_VAL // BATCH)
    check(acc["n"] == FOLDER_VAL, f"eval CLI: n = {acc['n']}")
    check(launches == 10 * forwards and wa.BWD_LAUNCHES == 0,
          f"eval CLI: {launches} K1 launches over {forwards} forwards, want 10 a forward")
    ips = acc["n"] / acc["seconds"]
    print(f"folder eval (cli.eval, tiny_vit_21m_224 bf16 bs{BATCH}, --torch-ckpt): "
          f"acc@1 {acc['acc1']:.3f} acc@5 {acc['acc5']:.3f} n {acc['n']}, {launches} K1 "
          f"launches ({forwards} forward), {ips:.1f} img/s (the CLI's wall, the loader "
          f"included) [{card_info()}]")
    return {"img_per_s": ips, "launches": launches, **acc}


def phase_folder() -> dict:
    """9z15-9z17 on one generated folder in a temporary directory under
    build/, deleted afterwards."""
    import tempfile

    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        root = Path(tmp)
        made = write_folder(root, FOLDER_TRAIN, FOLDER_VAL)
        print(f"folder: {made['images']} BMPs ({made['bytes'] / 2 ** 20:.1f} MiB) written in "
              f"{made['s']:.1f} s")
        res = {"loader": phase_folder_loader(root), "train": phase_folder_train(root),
               "eval": phase_folder_eval(root)}
    return res


# ---- JPEG data, tar shards and the gated ConvBN variants (slice 24) ----

JPEG_TRAIN, JPEG_VAL = 768, 512
# the native pipeline against the exact path (normalized units): JAX's own
# tolerance, tests/test_native_pipe.py
PIX_MEAN_TOL, PIX_MAX_TOL = 0.012, 0.40
GATE_ROUTES = ("off", "mxu_bn", "conv1x1_dot")


def write_jpeg_folder(root: Path, n_train: int, n_val: int, seed: int = 0) -> dict:
    """An ImageNet-style folder of JPEGs (quality 90) under `root`: train/
    and val/ with FOLDER_CLASSES class folders, images at sizes drawn from
    FOLDER_SIZES (`folder_image`, each from its own seed), val's first image
    a PNG; 8 writer threads (Pillow's encoder releases the GIL)."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    jobs = [(split, i) for split, n in (("train", n_train), ("val", n_val))
            for i in range(n)]
    for split in ("train", "val"):
        for c in range(FOLDER_CLASSES):
            (root / split / f"n{c:08d}").mkdir(parents=True)

    def write(job):
        split, i = job
        rng = np.random.default_rng([seed, split == "val", i, 24])
        w, h = FOLDER_SIZES[int(rng.integers(len(FOLDER_SIZES)))]
        png = (split, i) == ("val", 0)
        path = (root / split / f"n{i % FOLDER_CLASSES:08d}"
                / f"{split}_{i:05d}.{'png' if png else 'jpg'}")
        Image.fromarray(folder_image(rng, w, h)).save(path, **({} if png else {"quality": 90}))
        return path.stat().st_size

    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:
        nbytes = sum(pool.map(write, jobs))
    return {"images": len(jobs), "bytes": nbytes, "s": time.perf_counter() - t0}


def pixel_errors(got: np.ndarray, want: np.ndarray) -> tuple[float, float]:
    d = np.abs(got - want)
    return float(d.mean()), float(d.max())


def image_size(data: bytes) -> tuple[int, int]:
    """(width, height) of an image file's bytes, from Pillow's header read."""
    import io

    from PIL import Image
    with Image.open(io.BytesIO(data)) as im:
        return im.size


def prescaled(row) -> bool:
    """Whether image_pipe.cc decodes a params row at a reduced DCT scale
    (the box at least 12/7 of the resample size on both axes)."""
    return row[2] * 7 >= 12 * row[4] and row[3] * 7 >= 12 * row[5]


def phase_jpeg_pixels(root: Path) -> dict:
    """9z18. The native pipeline on this host (the library built from
    cream_tpu_torch/native/image_pipe.cc, the libjpeg it links) against the
    exact path on the JPEG folder: the first val batch's `eval_params` and
    the first train batch's `train_params` equal the exact path's decisions
    (`transforms.resize_size` / `crop_offsets`, `det_aug.rrc_box` and the
    flip coin on each decoded image); the eval batch's pixels (no
    prescaling) and the train batch's rows that decode at full scale within
    mean 0.012 / max 0.40 of the exact path, the PNG bit for bit; the rows
    that decode at a reduced DCT scale (prescaling, the train path's
    default) are counted and their distance printed."""
    from cream_tpu_torch.data import native_pipe
    from cream_tpu_torch.data.det_aug import rrc_box, sample_seed
    from cream_tpu_torch.data.imagenet import ImageFolder, eval_loader, train_loader
    from cream_tpu_torch.data.transforms import (crop_offsets, eval_preprocess_config,
                                                 resize_size)

    t0 = time.perf_counter()
    lib = native_pipe.build()
    build_s = time.perf_counter() - t0
    val, train = ImageFolder(str(root / "val")), ImageFolder(str(root / "train"))
    cfg = eval_preprocess_config(224)
    idx = list(range(BATCH))
    bufs = [val.load_bytes(i)[0] for i in idx]
    wh = native_pipe.probe_sizes(bufs)
    sizes = [image_size(b) for b in bufs]
    png = [i for i in idx if val.samples[i][0].endswith(".png")]
    check(png and all((wh[i] == 0).all() for i in png)
          and all(tuple(wh[i]) == sizes[i] for i in idx if i not in png),
          "probe_sizes against the decoded sizes")
    rows = native_pipe.eval_params(wh, cfg)
    for i in idx:
        if i in png:
            continue
        w, h = sizes[i]
        nw, nh = resize_size(w, h, cfg.resize_shorter)
        check(tuple(rows[i]) == (0, 0, w, h, nw, nh, *crop_offsets(nw, nh, cfg.crop), 0),
              f"eval decision row {i}: {rows[i]}")
    exact = next(eval_loader(val, BATCH, 224, num_workers=8))
    native = next(eval_loader(val, BATCH, 224, num_workers=8, native=True))
    check(np.array_equal(exact["label"], native["label"]), "eval labels")
    errs = [pixel_errors(native["image"][i], exact["image"][i]) for i in idx if i not in png]
    check(all(np.array_equal(native["image"][i], exact["image"][i]) for i in png),
          "the PNG's eval pixels are not the exact path's")
    eval_mean, eval_max = max(e[0] for e in errs), max(e[1] for e in errs)
    check(eval_mean < PIX_MEAN_TOL and eval_max < PIX_MAX_TOL,
          f"eval pixels: worst mean {eval_mean}, max {eval_max}")

    ex = next(train_loader(train, BATCH, 0, 0, 224, 8))
    nat = next(train_loader(train, BATCH, 0, 0, 224, 8, native=True))
    for k in ("label", "index", "seed"):
        check(np.array_equal(ex[k], nat[k]), f"train batch {k}")
    tbufs = [train.load_bytes(int(i))[0] for i in ex["index"]]
    trows = native_pipe.train_params(native_pipe.probe_sizes(tbufs), ex["seed"], 224)
    n_pre, pre_errs, full_errs = 0, [], []
    for r, i in enumerate(ex["index"]):
        w, h = image_size(tbufs[r])
        rng = np.random.default_rng(int(ex["seed"][r]))
        box = rrc_box(w, h, rng)
        flip = int(rng.random() < 0.5)
        check(int(ex["seed"][r]) == sample_seed(0, 0, int(i)), "train seed")
        check(tuple(trows[r]) == (*box, 224, 224, 0, 0, flip), f"train decision row {r}")
        e = pixel_errors(nat["image"][r], ex["image"][r])
        if prescaled(trows[r]):
            n_pre += 1
            pre_errs.append(e)
        else:
            full_errs.append(e)
    train_mean = max(e[0] for e in full_errs)
    train_max = max(e[1] for e in full_errs)
    check(train_mean < PIX_MEAN_TOL and train_max < PIX_MAX_TOL,
          f"train pixels at full scale: worst mean {train_mean}, max {train_max}")
    pre = (f"{n_pre} rows decode at a reduced DCT scale: worst mean "
           f"{max(e[0] for e in pre_errs):.4f}, max {max(e[1] for e in pre_errs):.4f}, median "
           f"mean {statistics.median(e[0] for e in pre_errs):.4f}" if pre_errs
           else "no row decodes at a reduced DCT scale")
    print(f"jpeg pixels: the native pipeline ({lib.name}, built in {build_s:.1f} s, libjpeg "
          f"{native_pipe.jpeg_library()}) on this host; the first val batch's {BATCH} eval "
          f"decision rows and the first train batch's {BATCH} RRC + flip rows equal the exact "
          f"path's; eval pixels (no prescaling) worst mean |d| {eval_mean:.4f}, max "
          f"{eval_max:.4f} (bounds {PIX_MEAN_TOL}, {PIX_MAX_TOL}), the PNG bit for bit; train "
          f"pixels at full scale ({len(full_errs)} rows) worst mean {train_mean:.4f}, max "
          f"{train_max:.4f}; {pre}")
    return {"eval_mean": eval_mean, "eval_max": eval_max, "train_mean": train_mean,
            "train_max": train_max, "prescaled_rows": n_pre, "build_s": build_s,
            "prescaled_worst_mean": max((e[0] for e in pre_errs), default=0.0)}


def phase_jpeg_eval(root: Path) -> dict:
    """9z19. main path (eval from a JPEG folder): cli.eval.main on the val
    folder (512 images, one a PNG), TinyViT-21M-224 bf16 bs256, seeded
    weights by --torch-ckpt, with data.native_loader=True and False: each
    run n = 512 and 10 K1 launches a forward; img/s by the CLI's wall (the
    loader included). Returns the K1 launches of both runs."""
    from cream_tpu_torch.cli import eval as eval_cli

    model = create_model("tiny_vit_21m_224", device="cpu")
    ckpt = root / "tiny_vit_21m_224_seed0.pth"
    torch.save(seeded_state_dict(model, 0), ckpt)
    del model
    forwards = -(-JPEG_VAL // BATCH)
    res, launches = {}, 0
    for native in (True, False):
        wa.LAUNCHES = wa.BWD_LAUNCHES = 0
        acc = eval_cli.main(["model.name=tiny_vit_21m_224", "model.dtype=bfloat16",
                             "data.dataset=imagenet", f"data.data_path={root}",
                             f"data.batch_size={BATCH}", "data.num_workers=8",
                             f"data.native_loader={native}", "--torch-ckpt", str(ckpt)])
        check(acc["n"] == JPEG_VAL, f"JPEG eval CLI native={native}: n = {acc['n']}")
        check(wa.LAUNCHES == 10 * forwards and wa.BWD_LAUNCHES == 0,
              f"JPEG eval CLI native={native}: {wa.LAUNCHES} K1 launches over {forwards} "
              f"forwards, want 10 a forward")
        launches += wa.LAUNCHES
        res[native] = {"img_per_s": acc["n"] / acc["seconds"], **acc}
    print(f"jpeg eval (cli.eval, tiny_vit_21m_224 bf16 bs{BATCH}, --torch-ckpt, {JPEG_VAL} "
          f"val images, {forwards} forwards, 10 K1 launches each): native_loader=True "
          f"{res[True]['img_per_s']:.1f} img/s (acc@1 {res[True]['acc1']:.4f}), False "
          f"{res[False]['img_per_s']:.1f} img/s (acc@1 {res[False]['acc1']:.4f}), the CLI's "
          f"wall with the loader [{card_info()}]")
    return {"native": res[True], "exact": res[False], "launches": launches}


def steady_rate(arrivals: list, skip: int) -> tuple[float, float]:
    """(img/s, s a batch) over the batches after the first `skip`:
    `arrivals` holds (time, images) per batch."""
    n = sum(k for _, k in arrivals[skip:])
    span = arrivals[-1][0] - arrivals[skip - 1][0]
    return n / span, span / (len(arrivals) - skip)


def phase_jpeg_loaders(root: Path) -> dict:
    """9z20. The loaders alone on the JPEG folder (no card work): the
    native eval_loader and the native plain RRC + flip train_loader (the
    C++ pool in the loader's thread, DCT prescaling on the train path), each
    over 3 passes of its images (`Cycle`), img/s steady over passes 2-3;
    beside them the exact path on 8 worker processes (Pillow's JPEG decode,
    the numpy resampler) over 1 pass, steady over the batches after its
    first (its passes cost ~5x the native's); the native batch's ms;
    os.cpu_count()."""
    from cream_tpu_torch.data.imagenet import ImageFolder, Workers, eval_loader, train_loader

    val, train = ImageFolder(str(root / "val")), ImageFolder(str(root / "train"))
    with Workers(len, 2) as pool:      # the fork server starts once a process
        pool.map(["warm"])
    res = {"cpus": os.cpu_count()}
    for native in (True, False):
        reps = 3 if native else 1
        for kind, ds in (("eval", val), ("train", train)):
            if kind == "eval":
                it = eval_loader(Cycle(ds, reps), BATCH, 224, num_workers=8, native=native)
            else:
                it = train_loader(Cycle(ds, reps), BATCH, 0, 0, 224, 8, native=native)
            arrivals = [(time.perf_counter(), int((b["label"] >= 0).sum())) for b in it]
            ips, per_batch = steady_rate(arrivals, len(arrivals) // 3 if native else 1)
            res[f"{kind}_{'native' if native else 'exact'}"] = {
                "img_per_s": ips, "batch_ms": per_batch * 1e3}
    print(f"jpeg loaders alone (bs{BATCH}, steady over passes 2-3 of 3, the exact path over "
          f"the batches after the first of 1 pass; no card work, "
          f"os.cpu_count() {res['cpus']}): eval_loader native "
          f"{res['eval_native']['img_per_s']:.1f} img/s ({res['eval_native']['batch_ms']:.1f} "
          f"ms a batch) vs exact on 8 worker processes {res['eval_exact']['img_per_s']:.1f}; "
          f"plain RRC + flip train_loader native {res['train_native']['img_per_s']:.1f} img/s "
          f"({res['train_native']['batch_ms']:.1f} ms a batch) vs exact "
          f"{res['train_exact']['img_per_s']:.1f}")
    return res


def phase_jpeg_train(root: Path) -> dict:
    """9z21. main path (training fed by the native pipeline): TinyViT-21M-224
    bf16 / fp32 params bs256, AdamW(1e-3, wd 0.05, clip 5), int labels, fed
    by train_loader(native=True) (plain RRC + flip) + prefetch over 3
    passes of the 768 JPEGs (9 batches): 10 + 10 K1/K2 launches a step,
    every loss finite; CUDA events over 4 steps after 2, the idle share of
    the 3 after those (`profile`); the upload's host ms a batch (154 MB of
    float32 to the card, cast there) and the loader's; the synthetic step's
    img/s of the same run (train_throughput, 5 after 2)."""
    from cream_tpu_torch.cli.profile_step import profile
    from cream_tpu_torch.data.imagenet import ImageFolder, prefetch, train_loader

    dtype = torch.bfloat16
    model = create_model("tiny_vit_21m_224", device="cuda", dtype=dtype)
    model.load_state_dict(seeded_state_dict(model, 0))
    state = TrainState(model, make_adamw(1e-3, weight_decay=0.05, clip_grad=5.0,
                                         params=dict(model.named_parameters())))
    step = make_train_step()
    ds = ImageFolder(str(root / "train"))
    warm, timed_steps, profiled = 2, 4, 3
    n_batches = 3 * JPEG_TRAIN // BATCH
    check(warm + timed_steps + profiled == n_batches, "the fed window's batch count")
    loader_ms, upload_ms, losses = [], [], []

    def timed_loader():
        it = train_loader(Cycle(ds, 3), BATCH, 0, 0, 224, 8, native=True)
        while True:
            t0 = time.perf_counter()
            b = next(it, None)
            if b is None:
                return
            loader_ms.append((time.perf_counter() - t0) * 1e3)
            yield b

    batches = prefetch(timed_loader())

    def fed_step():
        b = next(batches)
        t0 = time.perf_counter()
        images = torch.from_numpy(b["image"]).to("cuda").to(dtype)
        labels = torch.from_numpy(b["label"]).to("cuda")
        upload_ms.append((time.perf_counter() - t0) * 1e3)
        _, metrics = step(state, {"image": images, "label": labels}, 0)
        losses.append(metrics["loss"])

    wa.LAUNCHES = wa.BWD_LAUNCHES = 0
    for _ in range(warm):
        fed_step()
    torch.cuda.synchronize()
    window = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    window[0].record()
    for _ in range(timed_steps):
        fed_step()
    window[1].record()
    torch.cuda.synchronize()
    fed_ips = timed_steps * BATCH / (window[0].elapsed_time(window[1]) / 1e3)
    prof = profile(fed_step, steps=profiled, warmup=0, top=8)
    check(next(batches, None) is None, "the fed window left a batch of its loader")
    launches = (wa.LAUNCHES, wa.BWD_LAUNCHES)
    check(launches == (10 * n_batches, 10 * n_batches),
          f"native-fed train: K1/K2 launches {launches} over {n_batches} steps, want 10 + 10 "
          f"a step")
    losses = [float(v) for v in losses]
    check(all(np.isfinite(losses)), f"native-fed train: a loss is not finite: {losses}")
    synthetic = train_throughput(model, BATCH, 224, dtype, 5, 2)
    res = {"img_per_s": fed_ips, "synthetic_img_per_s": synthetic, "launches": launches,
           "upload_ms": statistics.median(upload_ms), "loader_ms": statistics.median(loader_ms),
           "losses": losses, **{k: prof[k] for k in ("wall_ms", "device_ms", "idle_share")}}
    print(f"jpeg train (tiny_vit_21m_224 bf16 bs{BATCH}, train_loader(native=True) + prefetch, "
          f"plain RRC + flip): K1/K2 launches {launches} over {n_batches} steps, losses "
          f"{[round(v, 4) for v in losses]}; tinyvit21m_224_native_fed_train_throughput "
          f"{fed_ips:.1f} img/s (CUDA events, {timed_steps} steps after {warm}) vs synthetic "
          f"{synthetic:.1f} img/s (5 after 2); the {profiled} steps after those: wall "
          f"{prof['wall_ms']:.1f} ms, device {prof['device_ms']:.1f} ms, idle share "
          f"{prof['idle_share']:.3f}; host ms a batch: the loader's next() {res['loader_ms']:.1f} "
          f"(median, in the prefetch thread), the upload (154 MB float32 to the card, cast "
          f"there) {res['upload_ms']:.1f} [{card_info()}]")
    return res


def write_shards(root: Path, files: list, per: int = 256, seed: int = 0) -> list[str]:
    """Tar shards of `per` (key.jpg | key.png, key.txt) pairs each under
    `root`, the images `files`' bytes in order, each caption a zero-shot
    template filled with a class name drawn from `seed`."""
    import io
    import tarfile

    from cream_tpu_torch.train.zero_shot import openai_imagenet_constants

    names, templates = openai_imagenet_constants()
    rng = np.random.default_rng([seed, 24])
    paths = []
    for s in range(len(files) // per):
        path = root / f"pairs-{s:03d}.tar"
        with tarfile.open(path, "w") as tf:
            for k, f in enumerate(files[s * per:(s + 1) * per]):
                caption = templates[int(rng.integers(len(templates)))].format(
                    names[int(rng.integers(len(names)))])
                for ext, payload in ((Path(f).suffix.lstrip("."), Path(f).read_bytes()),
                                     ("txt", caption.encode())):
                    info = tarfile.TarInfo(f"{s:03d}_{k:05d}.{ext}")
                    info.size = len(payload)
                    tf.addfile(info, io.BytesIO(payload))
        paths.append(str(path))
    return paths


def phase_jpeg_shards(root: Path) -> dict:
    """9z22. Image-text tar shards feeding TinyCLIP: 2 shards of 256 image +
    caption pairs (the val folder's 512 files: one PNG member) through data.shards.image_text_loader
    (CLIP normalization, eval resize + crop at 224, the port's tokenizer on
    merges learned as phase_zero_shot learns them) with native=True and
    False, each batch through TinyCLIP-39M/16's bf16 bs256 pair forward
    (cli.speed_test.pair_step): pairs/s from the shards (the loader, the
    upload and the forwards, synchronized at the end) beside the synthetic
    pairs/s of the same run (pair_throughput, 10 after 3); the two paths'
    pixels within mean 0.012 / max 0.40 of each other (the PNG bit for bit),
    their tokens equal."""
    from cream_tpu_torch.cli.speed_test import pair_step, pair_throughput
    from cream_tpu_torch.data.shards import ShardListDataset, image_text_loader
    from cream_tpu_torch.data.tokenizer import SimpleTokenizer, write_merges

    bpe = root / "merges.txt.gz"
    write_merges(bpe, zero_shot_merges())
    tok = SimpleTokenizer(str(bpe))
    t0 = time.perf_counter()
    val = sorted(str(p) for p in (root / "val").rglob("*.*"))
    ds = ShardListDataset(write_shards(root, val), seed=0)
    write_s = time.perf_counter() - t0
    model = create_model(TINYCLIP, device="cuda", dtype=torch.bfloat16)
    model.load_state_dict(seeded_state_dict(model, 0))
    model.eval()
    out = {}
    for native in (True, False):
        sims, batches = [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            for b in image_text_loader(ds, tok, 0, BATCH, 224, model.context_length, 8,
                                       native=native):
                images = torch.from_numpy(b["image"]).to("cuda").to(torch.bfloat16)
                text = torch.from_numpy(b["text"]).to("cuda").long()
                sims.append(pair_step(model, images, text).float().sum())
                batches.append(b)
            total = float(torch.stack(sims).sum())
        torch.cuda.synchronize()
        out[native] = {"pairs_per_s": len(batches) * BATCH / (time.perf_counter() - t0),
                       "batches": batches, "finite": bool(np.isfinite(total))}
    synthetic = pair_throughput(model, BATCH, torch.bfloat16, 10, 3)
    nat, ex = out[True]["batches"], out[False]["batches"]
    check(len(nat) == len(ex) == 2 and out[True]["finite"] and out[False]["finite"],
          "shard batches")
    png = [img[:4] == b"\x89PNG" for _, img, _ in ds.epoch_iter(0)]
    check(sum(png) == 1, "the shards hold one PNG member")
    worst = [0.0, 0.0]
    for bi, (g, w) in enumerate(zip(nat, ex)):
        check(np.array_equal(g["text"], w["text"]), "shard tokens differ between the paths")
        for r in range(BATCH):
            if png[bi * BATCH + r]:
                check(np.array_equal(g["image"][r], w["image"][r]),
                      "the PNG member's pixels are not the exact path's")
                continue
            e = pixel_errors(g["image"][r], w["image"][r])
            worst = [max(worst[0], e[0]), max(worst[1], e[1])]
    check(worst[0] < PIX_MEAN_TOL and worst[1] < PIX_MAX_TOL,
          f"shard pixels native vs exact: worst mean {worst[0]}, max {worst[1]}")
    print(f"jpeg shards (2 x 256 pairs of the val folder's files written in {write_s:.1f} s, "
          f"TinyCLIP-39M/16 bf16 "
          f"bs{BATCH} pair forwards): image_text_loader native=True "
          f"{out[True]['pairs_per_s']:.1f} pairs/s, False {out[False]['pairs_per_s']:.1f} "
          f"pairs/s (the loader, upload and forwards) vs synthetic {synthetic:.1f} pairs/s; "
          f"pixels native vs exact worst mean {worst[0]:.4f}, max {worst[1]:.4f}, the PNG bit "
          f"for bit, tokens equal [{card_info()}]")
    return {"native_pairs_per_s": out[True]["pairs_per_s"],
            "exact_pairs_per_s": out[False]["pairs_per_s"], "synthetic_pairs_per_s": synthetic,
            "pix_mean": worst[0], "pix_max": worst[1]}


class gates:
    """Sets the JAX package's two ConvBN gates for `route` ("off", "mxu_bn",
    "conv1x1_dot"), restoring them on exit."""

    def __init__(self, route: str):
        self.route = route

    def __enter__(self):
        from cream_tpu_torch.nn import layers
        from cream_tpu_torch.ops import bn as bn_ops
        self.saved = bn_ops.DEFAULT_MXU_BN, layers.DEFAULT_CONV1X1_DOT
        bn_ops.DEFAULT_MXU_BN = self.route == "mxu_bn"
        layers.DEFAULT_CONV1X1_DOT = self.route == "conv1x1_dot"

    def __exit__(self, *exc):
        from cream_tpu_torch.nn import layers
        from cream_tpu_torch.ops import bn as bn_ops
        bn_ops.DEFAULT_MXU_BN, layers.DEFAULT_CONV1X1_DOT = self.saved


def phase_gated() -> dict:
    """9z23. The gated ConvBN variants (off by default, as in JAX):
    TinyViT-21M-224 bf16 bs256 train steps (train_step_fn: AdamW, int
    labels) with every ConvBN's train-mode BN through ops.bn.bn_train_norm
    ("mxu_bn"), with every 1x1 ConvBN conv as a channel product
    ("conv1x1_dot") and with both off, each route's first step from the same
    weights and batch on one model: 10 + 10 K1/K2 launches a step, the first
    loss within 2 bf16 ulps and the grad norm within 2% of the gates-off
    step's; img/s in 2 interleaved rounds of 5 steps after 2; the BN device
    ms a step from `profile` (2 steps; the "batch norm" kernels, or the
    "mxu_batch_norm" ranges' kernels)."""
    from cream_tpu_torch.cli.profile_step import profile

    dtype = torch.bfloat16
    runs, first, ips, bn_ms = {}, {}, {r: [] for r in GATE_ROUTES}, {}
    wa.LAUNCHES = wa.BWD_LAUNCHES = 0
    model = create_model("tiny_vit_21m_224", device="cuda", dtype=dtype)
    sd = {k: v.clone() for k, v in seeded_state_dict(model, 0).items()}
    for route in GATE_ROUTES:
        model.load_state_dict(sd)       # each route's first step from the same weights
        runs[route] = train_step_fn(model, BATCH, 224, dtype)
        k = (wa.LAUNCHES, wa.BWD_LAUNCHES)
        with gates(route):
            _, first[route] = runs[route]()
        check((wa.LAUNCHES - k[0], wa.BWD_LAUNCHES - k[1]) == (10, 10),
              f"gated {route}: K1/K2 launches a step")
    for order in (GATE_ROUTES, GATE_ROUTES[::-1]):
        for route in order:
            with gates(route):
                ips[route].append(timed_images_per_s(runs[route], BATCH, 5, 2))
    for route in GATE_ROUTES:
        with gates(route):
            prof = profile(runs[route], steps=2, warmup=0, top=8, ranges=("mxu_batch_norm",))
        bn_ms[route] = prof["by_kind_ms"].get("batch norm", 0.0) + prof["ranges_ms"][
            "mxu_batch_norm"]
    steps = len(GATE_ROUTES) * (1 + 2 * 7 + 2)
    launches = (wa.LAUNCHES, wa.BWD_LAUNCHES)
    check(launches == (10 * steps, 10 * steps), f"gated steps: K1/K2 launches {launches}")
    l_ref, g_ref = float(first["off"]["loss"]), float(first["off"]["grad_norm"])
    loss_lim = 2 * 2.0 ** (np.floor(np.log2(l_ref)) - 7)
    for route in GATE_ROUTES[1:]:
        l, g = float(first[route]["loss"]), float(first[route]["grad_norm"])
        check(np.isfinite(l) and abs(l - l_ref) <= loss_lim,
              f"gated {route}: first loss {l} vs {l_ref} (bound {loss_lim})")
        check(abs(g - g_ref) <= 2e-2 * g_ref, f"gated {route}: grad norm {g} vs {g_ref}")
    print(f"gated ConvBN variants (tiny_vit_21m_224 bf16 bs{BATCH} train steps, 10 + 10 K1/K2 "
          f"a step): first loss / grad norm " + ", ".join(
              f"{r} {float(first[r]['loss']):.5f} / {float(first[r]['grad_norm']):.4f}"
              for r in GATE_ROUTES) + f" (loss bound {loss_lim:.2e}, grad norm 2%); img/s "
          f"(rounds forward / reversed): " + "; ".join(
              f"{r} {' / '.join(f'{v:.1f}' for v in ips[r])}" for r in GATE_ROUTES)
          + "; BN device ms a step " + ", ".join(f"{r} {bn_ms[r]:.2f}" for r in GATE_ROUTES)
          + f" [{card_info()}]")
    return {"img_per_s": ips, "bn_ms": bn_ms, "launches": launches,
            "first": {r: (float(v["loss"]), float(v["grad_norm"])) for r, v in first.items()}}


def phase_jpeg() -> dict:
    """9z18-9z22 on one generated JPEG folder and two shards in a temporary
    directory under build/, deleted afterwards, then 9z23."""
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        root = Path(tmp)
        made = write_jpeg_folder(root, JPEG_TRAIN, JPEG_VAL)
        print(f"jpeg folder: {made['images']} images ({made['bytes'] / 2 ** 20:.1f} MiB, one "
              f"PNG) written in {made['s']:.1f} s")
        res = {"pixels": phase_jpeg_pixels(root), "eval": phase_jpeg_eval(root),
               "loaders": phase_jpeg_loaders(root), "train": phase_jpeg_train(root),
               "shards": phase_jpeg_shards(root)}
    res["gated"] = phase_gated()
    return res


# ---- data parallelism (slice 23) ----

DP_BATCH = 256            # the global batch of the data-parallel phases


def dp_world() -> int:
    """The ranks of the card runs: two where two cards are present, else one."""
    return min(torch.cuda.device_count(), 2)


def dp_inputs(device) -> tuple[torch.nn.Module, dict]:
    """TinyViT-21M-224 bf16 on seeded weights (drop path 0.2, its default) and
    a seeded global batch of DP_BATCH low-frequency images with one-hot
    labels, on `device`: the same bits on every card."""
    gen = torch.Generator(device).manual_seed(5)
    model = create_model("tiny_vit_21m_224", device=device, dtype=torch.bfloat16)
    model.load_state_dict(seeded_state_dict(model, 0))
    x = smooth_images(gen, DP_BATCH).to(torch.bfloat16)
    labels = torch.randint(0, 1000, (DP_BATCH,), generator=gen, device=device)
    return model, {"image": x, "label": F.one_hot(labels, 1000).float()}


def dp_step_result(model: torch.nn.Module, batch: dict, rows: slice) -> dict:
    """One AdamW step (1e-3, weight decay 0.05, clip 5) of `model` on the
    rows `rows` of `batch`: the data-parallel step under a process group,
    the one-card step without; its loss, grad norm, K1/K2 launches and the
    BN running stats after it."""
    state = TrainState(model, make_adamw(1e-3, weight_decay=0.05, clip_grad=5.0,
                                         params=dict(model.named_parameters())))
    wa.LAUNCHES = wa.BWD_LAUNCHES = 0
    _, metrics = make_train_step(loss_fn=soft_target_ce)(
        state, {k: v[rows] for k, v in batch.items()}, 0)
    return {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
            "launches": (wa.LAUNCHES, wa.BWD_LAUNCHES),
            "stats": {k: v.float().cpu().numpy() for k, v in model.state_dict().items()
                      if k.endswith(("running_mean", "running_var"))}}


def check_dp_step(tag: str, got: dict, want: dict) -> dict:
    """The data-parallel step against the one-card step on the same global
    batch: loss within 2 bf16 ulps, grad norm within 2%, each BN running
    stat tensor within 1e-3 relative (L2; the largest element error over
    the tensor's largest |value| is printed beside it: the two BatchNorms'
    bf16 outputs round apart at a few elements, and the difference grows
    through the blocks as the kernel and plain paths' do), 10 K1 + 10 K2
    launches a rank-step. Returns the errors."""
    loss_lim = 2 * 2.0 ** (np.floor(np.log2(want["loss"])) - 7)
    stat_err = max(float(np.linalg.norm(got["stats"][k] - w) / max(np.linalg.norm(w), 1e-12))
                   for k, w in want["stats"].items())
    stat_max = max(float(np.abs(got["stats"][k] - w).max() / max(np.abs(w).max(), 1e-12))
                   for k, w in want["stats"].items())
    err = {"loss": abs(got["loss"] - want["loss"]), "loss_bound": loss_lim,
           "grad_norm_rel": abs(got["grad_norm"] - want["grad_norm"]) / want["grad_norm"],
           "bn_stats_rel": stat_err, "bn_stats_max_rel": stat_max, "launches": got["launches"]}
    print(f"dp {tag}: loss {got['loss']:.5f} vs one card {want['loss']:.5f} (|diff| "
          f"{err['loss']:.2e}, bound {loss_lim:.2e}); grad_norm {got['grad_norm']:.4f} vs "
          f"{want['grad_norm']:.4f} (rel {err['grad_norm_rel']:.2e}, bound 2e-2); BN running "
          f"stats rel err (L2) {stat_err:.2e} (bound 1e-3; largest element {stat_max:.2e} of "
          f"its tensor's max); K1/K2 launches a rank-step "
          f"{got['launches'][0]}/{got['launches'][1]}")
    check(got["launches"] == (10, 10), f"dp {tag}: {got['launches']} K1/K2 launches a "
          f"rank-step, want 10 + 10")
    check(err["loss"] <= loss_lim, f"dp {tag}: loss {got['loss']} vs {want['loss']}")
    check(err["grad_norm_rel"] <= 2e-2, f"dp {tag}: grad_norm {got['grad_norm']} vs "
          f"{want['grad_norm']}")
    check(stat_err <= 1e-3, f"dp {tag}: BN running stats err {stat_err}")
    return err


def dp_rank(out: str, steps: int = 5) -> None:
    """A rank of the 2-card check (`launch_ranks`): the data-parallel step on
    this rank's half of the global batch (its result to out/rank<r>.npz),
    then `steps` timed steps (CUDA events)."""
    port_mesh.init_distributed("cuda")
    r, w = port_mesh.rank(), port_mesh.world_size()
    device = port_mesh.local_device("cuda")
    model, batch = dp_inputs(device)
    n = DP_BATCH // w
    res = dp_step_result(model, batch, slice(r * n, (r + 1) * n))
    model, _ = dp_inputs(device)
    ips = timed_images_per_s(train_step_fn(model, n, 224), DP_BATCH, steps, 2)
    np.savez(Path(out) / f"rank{r}.npz", loss=res["loss"], grad_norm=res["grad_norm"],
             launches=np.asarray(res["launches"]), img_per_s=ips,
             **{f"stat|{k}": v for k, v in res["stats"].items()})
    port_mesh.barrier()
    dist.destroy_process_group()


def phase_dp_step() -> dict:
    """The data-parallel TinyViT-21M-224 bf16 step on a global batch of 256
    against the one-card step on the same batch and weights: in this
    process under a one-rank NCCL group, and (where two cards are present)
    on two ranks of one card each (`dp_rank`). Then the step's img/s by CUDA
    events, plain (no group), DP, DP, plain, and the DP step's profile: the
    device ms of the grad all-reduce and of the global BatchNorm (their
    `record_function` ranges) and of the NCCL kernels."""
    from cream_tpu_torch.cli.profile_step import profile
    w, steps = dp_world(), 5
    device = torch.device("cuda", torch.cuda.current_device())
    model, batch = dp_inputs(device)
    want = dp_step_result(model, batch, slice(None))
    ips = {"plain": [], "dp": []}
    model, _ = dp_inputs(device)
    plain_step = train_step_fn(model, DP_BATCH, 224)
    ips["plain"].append(timed_images_per_s(plain_step, DP_BATCH, steps, 2))
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0, device_id=device)
    try:
        model, _ = dp_inputs(device)
        err = {"one_rank": check_dp_step("1 rank (NCCL, in process)",
                                         dp_step_result(model, batch, slice(None)), want)}
        model, _ = dp_inputs(device)
        dp_step = train_step_fn(model, DP_BATCH, 224)
        wa.LAUNCHES = wa.BWD_LAUNCHES = 0
        for _ in range(2):
            ips["dp"].append(timed_images_per_s(dp_step, DP_BATCH, steps, 2))
        launches = (wa.LAUNCHES, wa.BWD_LAUNCHES)
        check(launches == (10 * 2 * (steps + 2),) * 2, f"dp timed steps launched {launches}")
        prof = profile(dp_step, steps=3, warmup=1,
                       ranges=("grad_all_reduce", "global_batch_norm"))
    finally:
        dist.destroy_process_group()
    ips["plain"].append(timed_images_per_s(plain_step, DP_BATCH, steps, 2))
    two = None
    if w == 2:
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as out:
            launch_ranks(2, ["-c", f"import chip_smoke as c; c.dp_rank({out!r})"], 600.0,
                         cwd=str(ROOT))
            ranks = [dict(np.load(Path(out) / f"rank{r}.npz")) for r in range(2)]
        got = {"loss": float(ranks[0]["loss"]), "grad_norm": float(ranks[0]["grad_norm"]),
               "launches": tuple(int(v) for v in ranks[0]["launches"]),
               "stats": {k[5:]: v for k, v in ranks[0].items() if k.startswith("stat|")}}
        err["two_ranks"] = check_dp_step("2 ranks (NCCL, a card each)", got, want)
        two = [float(r["img_per_s"]) for r in ranks]
    card = card_info()
    ranges = prof["ranges_ms"]
    print(f"dp step TinyViT-21M-224 bf16 global bs{DP_BATCH}, CUDA events over {steps} steps "
          f"after 2: plain {' / '.join(f'{v:.1f}' for v in ips['plain'])} img/s, data-parallel "
          f"(1 rank) {' / '.join(f'{v:.1f}' for v in ips['dp'])} img/s"
          + (f", 2 ranks {' / '.join(f'{v:.1f}' for v in two)} img/s (rank 0 / 1)" if two else
             ", 2 ranks: not run (one card)")
          + f"; DP step profile: device {prof['device_ms']:.2f} of {prof['wall_ms']:.2f} ms "
          f"(idle {prof['idle_share']:.3f}), grad all-reduce {ranges['grad_all_reduce']:.3f} ms, "
          f"global BatchNorm {ranges['global_batch_norm']:.3f} ms (fwd + bwd), NCCL kernels "
          f"{prof['by_kind_ms'].get('NCCL collectives', 0.0):.3f} ms a step, "
          f"{prof['launches']:.0f} launches [{card}]")
    return {"img_per_s": ips, "two_ranks_img_per_s": two, "errors": err, "profile": prof,
            "launches_per_rank_step": err["one_rank"]["launches"],
            "launches": (launches[0] + 10, launches[1] + 10)}


def phase_dp_cli() -> dict:
    """torchrun on the card: `python -m torch.distributed.run --standalone
    --nproc_per_node=W -m cream_tpu_torch.cli.train`, TinyViT-21M-224 bf16
    compute / fp32 params, the synthetic set, a global batch of 256 (256 / W
    rows a rank), the default recipe, one epoch (the synthetic set's 4 rank
    batches in W slices: 4 steps at W = 1, 2 at W = 2) and its eval; finite
    losses, 10 + 10 K1/K2 launches a rank-step (the CLI's own count on rank
    0)."""
    import re
    import subprocess
    w = dp_world()
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as out:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               f"--nproc_per_node={w}", "-m", "cream_tpu_torch.cli.train",
               "model.name=tiny_vit_21m_224", "model.dtype=bfloat16", "data.dataset=synthetic",
               f"data.batch_size={DP_BATCH // w}", "train.epochs=1", "train.warmup_epochs=0",
               f"output={out}"]
        env = {**os.environ, "PYTHONPATH": os.pathsep.join(
            p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p)}
        t0 = time.time()
        res = subprocess.run(cmd, cwd=str(ROOT), env=env, capture_output=True, text=True,
                             timeout=600)
        wall = time.time() - t0
    log = res.stdout + res.stderr
    check(res.returncode == 0, f"torchrun cli.train failed (rc {res.returncode}):\n"
          f"{log[-4000:]}")
    m = re.search(r"epoch 0: (\d+) steps, window-attention kernel launches on rank 0 "
                  r"K1 (\d+), K2 (\d+)", log)
    check(m is not None, f"torchrun cli.train printed no launch count:\n{log[-2000:]}")
    n_steps, k1, k2 = (int(g) for g in m.groups())
    loss = re.search(r"epoch 0 \[0/\d+\] .*?loss: ([-\d.naninf]+)", log)
    done = re.search(r"epoch 0 done in ([\d.]+)s acc@1=([\d.]+)", log)
    print(f"dp cli: torchrun --nproc_per_node={w} cli.train tiny_vit_21m_224 bf16 global "
          f"bs{DP_BATCH}: {n_steps} steps a rank, K1/K2 launches on rank 0 {k1}/{k2}, first "
          f"loss {loss.group(1) if loss else 'not printed'}, "
          f"{done.group(0) if done else 'no eval line'}; {wall:.1f} s with the processes' start "
          f"[{card_info()}]")
    # the synthetic set holds 4 rank batches (cli.train.build_dataset), cut into rank slices
    want = steps_per_epoch(4 * (DP_BATCH // w), DP_BATCH // w, w)
    check(n_steps == want and (k1, k2) == (10 * n_steps, 10 * n_steps),
          f"torchrun cli.train: {n_steps} steps (want {want}), K1/K2 {k1}/{k2}")
    check(loss is not None and np.isfinite(float(loss.group(1))), "torchrun cli.train loss")
    check(done is not None, "torchrun cli.train did not finish its epoch")
    return {"world": w, "steps": n_steps, "launches": (k1, k2), "seconds": wall}


def phase_dryrun() -> dict:
    """`core.dryrun.dryrun_multichip(W, device="cuda")`: a data-parallel
    TinyViT-5M step and the contrastive gradient through the gather on W
    NCCL ranks."""
    w = dp_world()
    t0 = time.time()
    res = dryrun_multichip(w, device="cuda")
    grad = res["contrastive"]["grad"]
    print(f"dryrun_multichip({w}, cuda): step {res['step']}, loss {res['loss']:.4f}, "
          f"grad_norm {res['grad_norm']:.2f}; contrastive loss {res['contrastive']['loss']:.4f}, "
          f"grad {grad.shape} finite; {time.time() - t0:.1f} s")
    check(res["step"] == 1 and np.isfinite(res["loss"]) and np.isfinite(grad).all(),
          "dryrun_multichip")
    return res


# ---- tensor × data parallelism of the CLIP towers (slice 25) ----

TP_MODEL = "tinyclip_vit_39m_16_text_19m"
TP_BATCH = 256            # the global batch of the tensor-parallel phase
TP_STEPS = 5              # timed steps, after 2
TP_ULPS = 4               # the hand-summed shards against the unsplit block
# the TP step against the one-card step: the loss at an fp32 scale (the bf16
# runs read 1e-4 to 4.4e-4; 2 bf16 ulps at 5.59 would be 6.25e-2, and a
# random-init contrastive loss sits near ln 256 whatever the features), and
# each tensor's grad within TP_GRAD_REL of its norm plus TP_GRAD_FLOOR of
# the global norm (on the CPU in bf16 at width 256 the intact split read a
# worst 2.2e-2; with copy_to_model's backward sum left out the LayerNorms
# upstream read 0.91 to 0.99)
TP_LOSS_ABS = 5e-3
TP_GRAD_REL, TP_GRAD_FLOOR = 0.1, 1e-3


def tp_model(device) -> torch.nn.Module:
    """TinyCLIP-39M/16 bf16 on seeded weights on `device`: the same bits on
    every card."""
    model = create_model(TP_MODEL, device=device, dtype=torch.bfloat16)
    model.load_state_dict(seeded_state_dict(model, 0))
    return model


def tp_step(model: torch.nn.Module, images: torch.Tensor, text: torch.Tensor):
    """One contrastive Adam step (1e-4, no decay: optax's adam) of `model`
    on its rows (`train.steps.make_contrastive_step`): under a process group
    the TP × DP step, without one the plain step. Returns (a callable that
    runs the next step, the first step's loss and grad norm)."""
    from cream_tpu_torch.train.steps import make_contrastive_step
    state = TrainState(model, make_adamw(1e-4, weight_decay=0.0))
    step = make_contrastive_step()
    _, metrics = step(state, images, text)
    first = {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"])}
    return (lambda: step(state, images, text)), first


def bf16_ulps(err: float, ref: torch.Tensor) -> float:
    """`err` in bf16 ulps at the largest |ref|."""
    return err / 2.0 ** (np.floor(np.log2(float(ref.float().abs().max()))) - 7)


def phase_tp_shards(full: torch.nn.Module) -> dict:
    """(a) The shard math at full width on this card: model ranks 0 and 1 of
    2 built from `full`'s weights (`split_clip`, no group: each returns its
    partial products), for the first vision block (197 tokens) and the
    first text block (77 tokens, causal) at bs TP_BATCH in bf16: the
    attention's and the MLP's partial outputs summed by hand (fp32, the
    replicated bias once, then bf16) and the block composed from them,
    each within TP_ULPS bf16 ulps of the unsplit one's largest |value|."""
    from cream_tpu_torch.core.tensor_parallel import ModelShard, row_parallel_out
    from cream_tpu_torch.models.clip import split_clip
    from cream_tpu_torch.nn.layers import linear
    halves = [split_clip(full, ModelShard(r, 2)) for r in range(2)]
    device = next(full.parameters()).device
    gen = torch.Generator(device).manual_seed(9)
    dt, errs = torch.bfloat16, {}
    for tower, length in (("vision", 197), ("text", 77)):
        def block(m):
            return (m.visual.transformer if tower == "vision" else m.transformer).resblocks[0]
        blk, parts = block(full), [block(h) for h in halves]
        width = blk.ln_1.weight.shape[0]
        x = torch.randn(TP_BATCH, length, width, generator=gen, device=device).to(dt)
        mask = (None if tower == "vision" else
                torch.full((length, length), -np.inf, device=device).triu(1))

        def attn_sum(y):
            return row_parallel_out(sum(p.attn.partial(y, mask) for p in parts),
                                    blk.attn.out_proj.bias, dt, None)

        def mlp_sum(y):
            return row_parallel_out(sum(p.mlp.partial(y, p.act, dt) for p in parts),
                                    blk.mlp.c_proj.bias, dt, None)
        with torch.no_grad():
            y = blk.ln_1(x)
            x1 = x + blk.attn(y, mask)
            z = blk.ln_2(x1)
            pairs = {"attn": (attn_sum(y), blk.attn(y, mask)),
                     "mlp": (mlp_sum(z), linear(blk.mlp.c_proj, blk.mlp.hidden(z, blk.act, dt),
                                                dt))}
            xs = x + attn_sum(y)
            pairs["block"] = (xs + mlp_sum(blk.ln_2(xs)), blk(x, mask))
        for part, (got, want) in pairs.items():
            err = float((got.float() - want.float()).abs().max())
            errs[f"{tower}_{part}"] = bf16_ulps(err, want)
    print(f"tp shards TinyCLIP-39M/16 bf16 bs{TP_BATCH}, model ranks 0 + 1 of 2 summed by hand "
          f"against the unsplit block (bf16 ulps at the largest |value|, bound {TP_ULPS}): "
          + ", ".join(f"{k} {v:.2f}" for k, v in errs.items()))
    for k, v in errs.items():
        check(v <= TP_ULPS, f"tp shards: {k} {v:.2f} bf16 ulps from the unsplit block")
    return errs


def tp_grads(model: torch.nn.Module, images: torch.Tensor, text: torch.Tensor) -> dict:
    """The contrastive loss's grads of `model` on this rank's rows, before
    any step: averaged over the data group and gathered whole over the
    model group (fp32; the one-card grads without a process group)."""
    from cream_tpu_torch.core.tensor_parallel import gather_tree
    from cream_tpu_torch.train.steps import contrastive_loss_and_grads, data_parallel_mean
    _, grads = contrastive_loss_and_grads(model, images, text)
    data_parallel_mean(grads, {})
    return {k: v.float() for k, v in gather_tree(grads, port_mesh.model_group()).items()}


def check_tp_grads(tag: str, got: dict, want: dict) -> float:
    """Each tensor's grad of a TP × DP step against the one-card step's:
    |got - want| within TP_GRAD_REL of |want| plus TP_GRAD_FLOOR of the
    global norm. Returns the worst |got - want| / |want|."""
    gn = float(global_norm(want.values()))
    worst, name, used = 0.0, "", 0.0
    for k, w in want.items():
        err, norm = float((got[k].to(w.device) - w).norm()), float(w.norm())
        used = max(used, err / (TP_GRAD_REL * norm + TP_GRAD_FLOOR * gn))
        if norm > 0 and err / norm > worst:
            worst, name = err / norm, k
    print(f"tp {tag}: per-tensor grads of {len(want)} tensors vs one card, worst "
          f"|diff|/|grad| {worst:.2e} ({name}); the most of the bound used {used:.3f} (bound "
          f"{TP_GRAD_REL:g} of |grad| + {TP_GRAD_FLOOR:g} of the global norm {gn:.4f})")
    check(used <= 1, f"tp {tag}: a grad beyond {TP_GRAD_REL:g} of its norm")
    return worst


def check_tp_step(tag: str, got: dict, want: dict) -> dict:
    """A TP × DP step against the plain one-card step on the same global
    batch: loss within TP_LOSS_ABS (below 2 bf16 ulps), grad norm within
    2%."""
    loss_lim = min(TP_LOSS_ABS, 2 * 2.0 ** (np.floor(np.log2(want["loss"])) - 7))
    err = {"loss": abs(got["loss"] - want["loss"]), "loss_bound": loss_lim,
           "grad_norm_rel": abs(got["grad_norm"] - want["grad_norm"]) / want["grad_norm"]}
    print(f"tp {tag}: loss {got['loss']:.5f} vs one card {want['loss']:.5f} (|diff| "
          f"{err['loss']:.2e}, bound {loss_lim:.2e}); grad_norm {got['grad_norm']:.4f} vs "
          f"{want['grad_norm']:.4f} (rel {err['grad_norm_rel']:.2e}, bound 2e-2)")
    check(err["loss"] <= loss_lim, f"tp {tag}: loss {got['loss']} vs {want['loss']}")
    check(err["grad_norm_rel"] <= 2e-2, f"tp {tag}: grad_norm {got['grad_norm']} vs "
          f"{want['grad_norm']}")
    return err


def tp_rank(out: str, model: int, steps: int = TP_STEPS) -> None:
    """A rank of the multi-card check (`launch_ranks`): the (W // model,
    model) layout (`init_distributed(model=)`), the split TinyCLIP-39M/16 on
    this rank's data rows of the global batch, its first step's loss and
    grad norm, then the pairs/s of `steps` timed steps (CUDA events) and the
    device ms of the model group's and the data group's all-reduces a step
    (`profile` ranges); to out/rank<r>.npz."""
    from cream_tpu_torch.cli.profile_step import profile
    from cream_tpu_torch.cli.speed_test import pair_inputs
    from cream_tpu_torch.core.tensor_parallel import current_shard
    from cream_tpu_torch.models.clip import split_clip
    port_mesh.init_distributed("cuda", model=model)
    device = port_mesh.local_device("cuda")
    full = tp_model(device)
    images, text = pair_inputs(full, TP_BATCH, seed=3)
    n, d = TP_BATCH // port_mesh.data_size(), port_mesh.data_rank()
    rows = images[d * n:(d + 1) * n], text[d * n:(d + 1) * n]
    split = split_clip(full, current_shard())
    del full
    grads = tp_grads(split, *rows)
    if port_mesh.rank() == 0:
        torch.save({k: v.cpu() for k, v in grads.items()}, Path(out) / "grads.pt")
    del grads
    run, first = tp_step(split, *rows)
    pairs = timed_images_per_s(run, TP_BATCH, steps, 2)
    prof = profile(run, steps=3, warmup=1, ranges=("model_all_reduce", "grad_all_reduce"))
    np.savez(Path(out) / f"rank{port_mesh.rank()}.npz", pairs_per_s=pairs,
             layout=np.asarray([port_mesh.data_size(), port_mesh.model_size()]),
             model_ar_ms=prof["ranges_ms"]["model_all_reduce"],
             grad_ar_ms=prof["ranges_ms"]["grad_all_reduce"], device_ms=prof["device_ms"],
             wall_ms=prof["wall_ms"], **first)
    port_mesh.barrier()
    dist.destroy_process_group()


def phase_tp() -> dict:
    """Tensor × data parallelism of the CLIP towers (`core.tensor_parallel`,
    `models.clip` split by heads, `train.steps.make_contrastive_step`):
    (a) the shards summed by hand against the unsplit blocks
    (`phase_tp_shards`); the TP step at (data 1, model 1) under a one-rank
    NCCL group in this process (its blocks split over that group, every
    model-group sum an NCCL all-reduce) against the plain step on the same
    global batch of TP_BATCH (`check_tp_step`, and the first step's grads
    per tensor: `check_tp_grads`), pairs/s by CUDA events plain, TP, TP, plain,
    and the TP step's profile with the model group's all-reduces' device ms;
    (b) with 2 or more cards (data 1, model 2), with 4 or more also (data
    2, model 2), each a card a rank (`tp_rank`), against the one-card step,
    and `dryrun_multichip(4, "cuda")`'s three checks."""
    from cream_tpu_torch.cli.profile_step import profile
    from cream_tpu_torch.cli.speed_test import pair_inputs
    from cream_tpu_torch.core.tensor_parallel import ModelShard
    from cream_tpu_torch.models.clip import split_clip
    device = torch.device("cuda", torch.cuda.current_device())
    gc.collect()
    torch.cuda.empty_cache()
    full = tp_model(device)
    res = {"shards_ulps": phase_tp_shards(full)}
    images, text = pair_inputs(full, TP_BATCH, seed=3)
    want_grads = tp_grads(full, images, text)
    plain, want = tp_step(copy.deepcopy(full), images, text)
    pairs = {"plain": [timed_images_per_s(plain, TP_BATCH, TP_STEPS, 2)], "tp": []}
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0, device_id=device)
    try:
        split = split_clip(full, ModelShard(0, 1, dist.group.WORLD))
        tag = "(data 1, model 1) in process, one-rank NCCL group"
        grads_rel = {"1x1": check_tp_grads(tag, tp_grads(split, images, text), want_grads)}
        run, got = tp_step(split, images, text)
        res["errors"] = {"1x1": check_tp_step(tag, got, want)}
        for _ in range(2):
            pairs["tp"].append(timed_images_per_s(run, TP_BATCH, TP_STEPS, 2))
        prof = profile(run, steps=3, warmup=1, ranges=("model_all_reduce", "grad_all_reduce"))
    finally:
        dist.destroy_process_group()
    pairs["plain"].append(timed_images_per_s(plain, TP_BATCH, TP_STEPS, 2))
    del full, plain, run, split
    gc.collect()
    torch.cuda.empty_cache()
    res.update(pairs_per_s=pairs, profile=prof, layouts={}, grads_rel=grads_rel)
    cards = torch.cuda.device_count()
    for world, model in ((2, 2), (4, 2)):
        if cards < world:
            continue
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as out:
            launch_ranks(world, ["-c", f"import chip_smoke as c; c.tp_rank({out!r}, {model})"],
                         600.0, cwd=str(ROOT))
            ranks = [dict(np.load(Path(out) / f"rank{r}.npz")) for r in range(world)]
            got_grads = torch.load(Path(out) / "grads.pt")
        tag = f"(data {world // model}, model {model})"
        grads_rel[tag] = check_tp_grads(f"{tag}, a card a rank", got_grads, want_grads)
        del got_grads
        res["errors"][tag] = check_tp_step(
            f"{tag}, a card a rank", {k: float(ranks[0][k]) for k in ("loss", "grad_norm")},
            want)
        res["layouts"][tag] = {k: [float(r[k]) for r in ranks]
                               for k in ("pairs_per_s", "model_ar_ms", "grad_ar_ms",
                                         "device_ms", "wall_ms")}
    if cards >= 4:
        t0 = time.time()
        dry = dryrun_multichip(4, device="cuda")
        t = dry["tensor_parallel"]
        print(f"dryrun_multichip(4, cuda): step {dry['step']}, loss {dry['loss']:.4f}; "
              f"contrastive loss {dry['contrastive']['loss']:.4f}; tensor parallelism at "
              f"(data {t['layout'][0]}, model {t['layout'][1]}): loss {t['loss']:.4f}, in_proj "
              f"grads {t['in_proj_grad_shapes']}; {time.time() - t0:.1f} s")
        res["dryrun4"] = {"loss": dry["loss"], "tensor_parallel": t}
    ranges = prof["ranges_ms"]
    print(f"tp step TinyCLIP-39M/16 bf16 global bs{TP_BATCH}, CUDA events over {TP_STEPS} "
          f"steps after 2: plain {' / '.join(f'{v:.1f}' for v in pairs['plain'])} pairs/s, "
          f"(data 1, model 1) {' / '.join(f'{v:.1f}' for v in pairs['tp'])} pairs/s; its "
          f"profile: device {prof['device_ms']:.2f} of {prof['wall_ms']:.2f} ms (idle "
          f"{prof['idle_share']:.3f}), model-group all-reduces {ranges['model_all_reduce']:.3f} "
          f"ms, grad all-reduce {ranges['grad_all_reduce']:.3f} ms a step"
          + "".join(f"; {tag} pairs/s by rank "
                    + " / ".join(f"{v:.1f}" for v in lay["pairs_per_s"])
                    + ", model-group all-reduces " + " / ".join(f"{v:.3f}"
                                                               for v in lay["model_ar_ms"])
                    + " ms, grad all-reduce " + " / ".join(f"{v:.3f}" for v in lay["grad_ar_ms"])
                    + " ms a step" for tag, lay in res["layouts"].items())
          + ("" if res["layouts"] else "; more layouts not run: one card")
          + f" [{card_info()}]")
    return res


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
    t_dp = time.time()
    dp_step = phase_dp_step()
    dp_cli = phase_dp_cli()
    dryrun = phase_dryrun()
    dp_s = time.time() - t_dp
    t_tp = time.time()
    tp = phase_tp()
    tp_s = time.time() - t_tp
    for name in ("s3_tiny", "swin_tiny", "mini_swin_tiny"):
        phase_golden(name, DATA / f"{name}_seed0.npz")
    phase_train_golden("s3_tiny", DATA / "s3_tiny_train_seed0.npz")
    k1_swin = (phase_main("s3_tiny", S3T_BATCH, 12, rounds=2, lim_ulps=8)
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
    clip_steps = phase_clip_train_steps(steps=10)
    clip_stages = phase_clip_pipeline()
    check((wa.LAUNCHES, wa.BWD_LAUNCHES) == launches, "the CLIP phases launched K1/K2")
    counts = kernel_counts()
    phase_deit_goldens()
    deit_eval = {name: phase_deit_eval(name) for name in DEIT_METRICS}
    deit_train = {name: phase_deit_train(name, steps=6) for name in DEIT_METRICS}
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
    t_darts = time.time()
    retrain = phase_cdarts_retrain()
    darts_search = phase_darts_search()
    stage = phase_cdarts_stage()
    nb201 = phase_nb201(steps=5)
    darts_s = time.time() - t_darts
    t_det = time.time()
    phase_det_goldens()
    worst_det_k4, det_k4 = phase_det_k4(gen)
    det_eval = {name: phase_det_eval(name) for name in DET_METRICS}
    det_train = {}
    for name in DET_METRICS:
        dwconv.reset_launches()
        det_train[name] = phase_det_train(name, steps=6)
    det_clis = phase_det_clis()
    det_s = time.time() - t_det
    t_seg = time.time()
    phase_rn_pool_grad()
    counts = kernel_counts()
    phase_detr_golden()
    detr_eval = phase_detr_eval()
    detr_train = phase_detr_train(steps=6)
    check(kernel_counts() == counts, "the DETR phases launched a kernel")
    phase_cydas_golden()
    counts = kernel_counts()
    cyd_eval = phase_cydas_eval()
    check(kernel_counts() == counts, "the CyDAS eval phase launched a kernel")
    dwconv.reset_launches()
    cyd_train = phase_cydas_train(steps=6)
    seg_clis = phase_seg_clis()
    seg_s = time.time() - t_seg
    t_folder = time.time()
    pixels = phase_pixels()
    folder = phase_folder()
    folder_s = time.time() - t_folder
    t_jpeg = time.time()
    jpeg = phase_jpeg()
    jpeg_s = time.time() - t_jpeg
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
             k1_eval + k1_train + k1_swin + k1_s3_train + k1_distill
             + folder["train"]["launches"][0] + folder["eval"]["launches"]
             + dp_step["launches"][0] + dp_cli["launches"][0] + jpeg["eval"]["launches"]
             + jpeg["train"]["launches"][0] + jpeg["gated"]["launches"][0], worst_k1, t1),
            ("window_attention_bwd", "window_attention_bwd.cu", 268,
             k2_train + k2_s3_train + k2_distill + folder["train"]["launches"][1]
             + dp_step["launches"][1] + dp_cli["launches"][1] + jpeg["train"]["launches"][1]
             + jpeg["gated"]["launches"][1], worst_k2, t2)):
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
    for row, i in zip(rows, (0, 1)):
        row["jpeg_launches"] = {"cli_eval_native_and_exact": jpeg["eval"]["launches"] * (1 - i),
                                "native_fed_train": jpeg["train"]["launches"][i],
                                "gated_steps": jpeg["gated"]["launches"][i]}
        row["data_parallel_launches"] = {"per_rank_step": dp_step["launches_per_rank_step"][i],
                                         "dp_step_phase": dp_step["launches"][i],
                                         "torchrun_cli_rank0": dp_cli["launches"][i]}
    rows.append(evit_row(
        "cga_fused", "cga.cu", "cga.py:56",
        sum(v["cascade"][0] for v in evit.values())
        + sum(v["k4_launches"] for v in det_eval.values()),
        max(worst_k4, worst_det_k4), t4, ("ms", "host_ms", "plain_ms", "plain_host_ms",
                                          "module_ms", "module_host_ms", "bound_ms"),
        {"library_ms": None, "library_note": "no single PyTorch call computes the whole "
         "cascade; module_ms is the unfused plain-route CGA module on the same input",
         "forward_graph_ms": evit_graph, "efficientvit_m4_canvas512_bs16_forward": det_k4,
         "detector_eval_launches": {n: v["k4_launches"] for n, v in det_eval.items()}}))
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
            "launches": (evit_train[route][key] + tv_train[key] + cream["launches"][key]
                         + darts_search["launches"][key] + retrain["launches"][key]
                         + sum(v["main_path_launches"][key] for v in det_train.values())
                         + cyd_train["main_path_launches"][key]),
            "max_abs_err": worst_dw[key],
            **{k: sum(tdw[n][kind][k] * per for n, per in sites)
               for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
            "bound_by": max((tdw[n][kind] for n, _ in sites),
                            key=lambda r: r["bound_ms"])["bound_by"],
            "tinyvit21m_step": per_step(tdw, DW_TINYVIT, kind, stride),
            "cream_supernet_step_launches": [n[key] for n in cream["launches_per_step"]],
            "darts_search_step_launches": [n[key] for n in darts_search["launches_per_step"]],
            "cdarts_retrain_forward_launches": retrain["launches"][key],
            "detector_train_step_launches": {n: v["per_step"][key] for n, v in det_train.items()},
            "cydas_seg_step_launches": cyd_train["per_step"][key]})
        if stride == 1 and kind != "wgrad":               # K7 at CyDAS's six sites, a step
            rows[-1]["cydas_seg_step"] = per_step(tdw, cydas_dw_sites(), kind, 1)
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
          f"distill steps) K1/K2 {k1_distill}/{k2_distill}; training and eval from an image "
          f"folder, cli.train and cli.eval, K1/K2 {folder['train']['launches']} and "
          f"{folder['eval']['launches']}); per EfficientViT-M5 bf16 bs512 "
          f"forward (K4, K5), "
          f"launches on the M5 bs512 + M0 bs1024 eval paths' cascade (K4) and core (K5) routes; "
          f"per EfficientViT-M5 bf16 bs512 train step (K7/K8/K9: the sum over its depthwise "
          f"sites; under tinyvit21m_step the sum over a TinyViT-21M-224 bf16 bs256 train "
          f"step's), launches on the M5 train path's fused (K7, K9) and wgrad (K8) routes "
          f"and the TinyViT train path's fused route, with the Cream supernet steps', the DARTS "
          f"search steps' and the CDARTS retrain forward's on fused; "
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
    print(f"CDARTS / DARTS / NAS-Bench-201 (phases 9v-9y, {darts_s:.1f} s): "
          f"cdarts_retrain_imagenet bf16 bs{BATCH} library / fused "
          f"{retrain['img_per_s']['library']:.1f} / {retrain['img_per_s']['fused']:.1f} img/s, "
          f"train bs{RETRAIN_TRAIN_BATCH} {retrain['train_img_per_s']:.1f} img/s (peak "
          f"{retrain['peak_gib']:.2f} GiB); darts_search_cifar bf16 bs{DARTS_BATCH} ms a weight / "
          f"alpha step: " + "; ".join(
              f"{r} {darts_search['ms'][r]['weight']:.2f} / {darts_search['ms'][r]['alpha']:.2f}"
              for r in ("library", "fused"))
          + f" (fused idle share {darts_search['profile']['fused']['idle_share']:.3f})"
          + f"; staged search CLI {stage['cli_s']:.1f} s (s a joint step "
          f"{stage['step_s']['joint']:.3f}); nasbench201_search {nb201['search_ms']:.2f} ms a "
          f"step, nasbench201_infer {nb201['infer_img_per_s']:.1f} img/s; K7/K9 launches on the "
          f"DARTS fused steps {darts_search['launches']} [{card}]")
    print(f"detection (phases 9z1-9z5, {det_s:.1f} s), bf16 bs{DET_BATCH} canvas {DET_CANVAS}: "
          + "; ".join(f"{DET_METRICS[n]}_infer_throughput {det_eval[n]['img_per_s']:.1f} img/s "
                      f"(+ decode {det_eval[n]['decode_img_per_s']:.1f}, peak "
                      f"{det_eval[n]['peak_gib']:.2f} GiB, idle {det_eval[n]['idle_share']:.3f}, "
                      f"{det_eval[n]['gflop_per_image']:.1f} GFLOP an image, bound "
                      f"{det_eval[n]['bound_ms']:.3f} ms a batch), "
                      f"{DET_METRICS[n]}_train_throughput "
                      + " / ".join(f"{r} {statistics.median(det_train[n]['img_per_s'][r]):.1f}"
                                   for r in ("library", "fused"))
                      + f" img/s (medians; peak {det_train[n]['peak_gib']['fused']:.2f} GiB, idle "
                      f"{det_train[n]['idle_share']:.3f})" for n in DET_METRICS)
          + f"; K4 per M4 backbone forward {det_k4['ms']:.4f} ms (bound {det_k4['bound_ms']:.4f}); "
          f"CLIs' native AP " + ", ".join(f"{n} {r['metrics']}" for n, r in det_clis.items())
          + f" [{card}]")
    print(f"DETR iRPE / CyDAS segmentation (phases 9z6-9z13, {seg_s:.1f} s): "
          f"detr_r50_irpe_512_infer_throughput bf16 bs{DETR_BATCH} {detr_eval['img_per_s']:.1f} "
          f"img/s (+ post_process {detr_eval['decode_img_per_s']:.1f}, peak "
          f"{detr_eval['peak_gib']:.2f} GiB, idle {detr_eval['idle_share']:.3f}), "
          f"detr_r50_irpe_512_train_throughput {statistics.median(detr_train['img_per_s']):.1f} "
          f"img/s (median; peak {detr_train['peak_gib']:.2f} GiB, idle "
          f"{detr_train['idle_share']:.3f}); cydas_seg_1024x2048_infer_throughput bf16 "
          f"bs{SEG_BATCH} {cyd_eval['img_per_s']:.2f} img/s (peak {cyd_eval['peak_gib']:.2f} GiB, "
          f"idle {cyd_eval['idle_share']:.3f}), cydas_seg_769_train_throughput library / fused "
          + " / ".join(f"{statistics.median(cyd_train['img_per_s'][r]):.2f}"
                       for r in ("library", "fused"))
          + f" img/s (medians; fused peak {cyd_train['peak_gib']['fused']:.2f} GiB, idle "
          f"{cyd_train['idle_share']:.3f}); CLIs {[(n, r['losses'][-1]) for n, r in seg_clis.items()]}"
          f" [{card}]")
    ft, fl = folder["train"], folder["loader"]
    print(f"image-folder data (phases 9z14-9z17, {folder_s:.1f} s): the port's "
          f"TrainAugConfig() transform {pixels['transform_ms']:.2f} ms an image at 500x375 "
          f"(eval preprocessing {pixels['eval_ms']:.2f}); folder_loader_img_per_s "
          f"{fl['train_img_per_s']:.1f} ({fl['steady_img_per_s']:.1f} steady; "
          f"eval loader {fl['eval_img_per_s']:.1f}) on "
          f"{fl['cpus']} CPUs; tinyvit21m_224_folder_train_throughput "
          f"{ft['folder_img_per_s']:.1f} img/s steady "
          f"({ft['folder_img_per_s'] / fl['steady_img_per_s']:.3f}x the loader's steady rate; "
          f"cli.train's 3-step epoch {ft['epoch_img_per_s']:.1f}) vs synthetic "
          f"{ft['synthetic_img_per_s']:.1f}, idle share of a steady folder-fed step "
          f"{ft['idle_share']:.3f}; peak "
          f"{ft['peak_gib']:.2f} GiB, remat_stem {ft['remat_peak_gib']:.2f} GiB; cli.eval "
          f"{folder['eval']['img_per_s']:.1f} img/s [{card}]")
    jp, jt, jl = jpeg["pixels"], jpeg["train"], jpeg["loaders"]
    print(f"JPEG data (phases 9z18-9z23, {jpeg_s:.1f} s): cli.eval JPEG folder native / exact "
          f"{jpeg['eval']['native']['img_per_s']:.1f} / {jpeg['eval']['exact']['img_per_s']:.1f} "
          f"img/s; loaders alone native / exact: eval {jl['eval_native']['img_per_s']:.1f} / "
          f"{jl['eval_exact']['img_per_s']:.1f}, plain train {jl['train_native']['img_per_s']:.1f}"
          f" / {jl['train_exact']['img_per_s']:.1f} img/s on {jl['cpus']} CPUs; "
          f"tinyvit21m_224_native_fed_train_throughput {jt['img_per_s']:.1f} img/s (idle share "
          f"{jt['idle_share']:.3f}) vs synthetic {jt['synthetic_img_per_s']:.1f}; TinyCLIP pairs "
          f"from shards native / exact {jpeg['shards']['native_pairs_per_s']:.1f} / "
          f"{jpeg['shards']['exact_pairs_per_s']:.1f} vs synthetic "
          f"{jpeg['shards']['synthetic_pairs_per_s']:.1f} pairs/s; pixels worst mean eval "
          f"{jp['eval_mean']:.4f}, train {jp['train_mean']:.4f} ({jp['prescaled_rows']} rows "
          f"prescaled, worst mean {jp['prescaled_worst_mean']:.4f}); gated steps img/s "
          + ", ".join(f"{r} {statistics.median(v):.1f}" for r, v in jpeg["gated"]["img_per_s"].items())
          + " (medians), BN device ms " + ", ".join(
              f"{r} {v:.2f}" for r, v in jpeg["gated"]["bn_ms"].items()) + f" [{card}]")
    ips = dp_step["img_per_s"]
    print(f"data parallelism (phases 9a0-9a2, {dp_s:.1f} s), {torch.cuda.device_count()} "
          f"card(s), W = {dp_world()}, NCCL {'.'.join(map(str, torch.cuda.nccl.version()))}: "
          f"tinyvit21m_224_dp_train_throughput bf16 global bs{DP_BATCH} "
          f"{statistics.median(ips['dp']):.1f} img/s (1 rank; the plain step "
          f"{statistics.median(ips['plain']):.1f} in the same run"
          + (f"; 2 ranks {statistics.median(dp_step['two_ranks_img_per_s']):.1f}"
             if dp_step["two_ranks_img_per_s"] else "; 2 ranks not run: one card")
          + f"), grad all-reduce {dp_step['profile']['ranges_ms']['grad_all_reduce']:.3f} ms and "
          f"global BatchNorm {dp_step['profile']['ranges_ms']['global_batch_norm']:.3f} ms of "
          f"device time a step; torchrun cli.train {dp_cli['steps']} steps in "
          f"{dp_cli['seconds']:.1f} s; dryrun_multichip({dp_world()}) loss {dryrun['loss']:.4f} "
          f"[{card}]")
    tpp = tp["pairs_per_s"]
    print(f"tensor × data parallelism of the CLIP towers (phase 9a3, {tp_s:.1f} s), "
          f"{torch.cuda.device_count()} card(s): TinyCLIP-39M/16 contrastive step bf16 global "
          f"bs{TP_BATCH} at (data 1, model 1) {statistics.median(tpp['tp']):.1f} pairs/s (the "
          f"plain step {statistics.median(tpp['plain']):.1f} in the same run), model-group "
          f"all-reduces {tp['profile']['ranges_ms']['model_all_reduce']:.3f} ms of device time "
          f"a step; the shards summed by hand within "
          f"{max(tp['shards_ulps'].values()):.2f} bf16 ulps of the unsplit blocks"
          + "".join(f"; {tag} {statistics.median(lay['pairs_per_s']):.1f} pairs/s"
                    for tag, lay in tp["layouts"].items()) + f" [{card}]")
    print(f"total wall time {time.time() - t_start:.1f} s, the build included")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
