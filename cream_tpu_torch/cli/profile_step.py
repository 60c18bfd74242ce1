"""Where a forward or a train step spends its device time, by kernel.

    python -m cream_tpu_torch.cli.profile_step --models tiny_vit_21m_224
    python -m cream_tpu_torch.cli.profile_step --train       # AdamW train steps
    python -m cream_tpu_torch.cli.profile_step --models efficientvit_m5 --batch 512
    python -m cream_tpu_torch.cli.profile_step --train --models efficientvit_m5 \
        --batch 512 dw_kernel=fused                      # model keyword arguments
    python -m cream_tpu_torch.cli.profile_step mbconv_kernel=true pin_layouts=true
    python -m cream_tpu_torch.cli.profile_step --models tiny_vit_21m_384 --batch 64
    python -m cream_tpu_torch.cli.profile_step [--train] --models s3_tiny --batch 128
    python -m cream_tpu_torch.cli.profile_step --models tinyclip_vit_39m_16_text_19m \
        --batch 256 [--train]                            # a CLIP pair forward
                                                         # (--train: the L0 distill step)
    python -m cream_tpu_torch.cli.profile_step [--train] \
        --models deit_small_patch16_224_ctx_product_50_shared_k \
        mini_deit_small_patch16_224 drop_path_rate=0.1   # iRPE: gather / scatter-add
    python -m cream_tpu_torch.cli.profile_step [--train] --models \
        autoformer_supernet_tiny cream_supernet --batch 128 config=largest  # a supernet at
                                                         # a fixed config (smallest, seed:N)
    python -m cream_tpu_torch.cli.profile_step [--train] --models darts_search_cifar \
        --batch 64 [dw_kernel=fused]                     # a search net at seeded alphas
                                                         # (--train: its weight step)
    python -m cream_tpu_torch.cli.profile_step [--train | --decode] --models \
        retinanet_efficientvit_m4 mask_rcnn_efficientvit_m4 --batch 16 [dw_kernel=fused]
    python -m cream_tpu_torch.cli.profile_step [--train | --decode] --models detr_resnet50 \
        --batch 16 enc_rpe2d=rpe-2.0-product-ctx-1-k aux_loss=true
    python -m cream_tpu_torch.cli.profile_step [--train] --models cydas_seg --batch 12 \
        [dw_kernel=fused]

Runs `--warmup` untimed iterations, then `--steps` under `torch.profiler`
(CPU and CUDA activity) and prints one JSON line: the wall time per
iteration (host clock around the profiled iterations, ending in a
synchronize), the device time per iteration (union of the kernels' busy
intervals), the device idle share (1 - device/wall), the device time by
kind of kernel, and the top kernels by name, beside the card's name and
power limit. The train steps are those of `speed_test.train_throughput`
(random images, int labels, adamw(1e-3, weight_decay=0.05), the variant's
drop path). `--plain-attention` swaps every attention kernel for its plain
PyTorch version (TinyViT's and Swin/S3's window attention, EfficientViT's
CGA route "plain"); `key=value` words are model keyword arguments, as in
`speed_test`; `--img-size` defaults to each model's own. A two-tower CLIP
model runs `speed_test.pair_step` on `speed_test.pair_inputs` (both towers,
their similarity matrix); with `--train`, TinyCLIP's L0 distillation step
(`speed_test.tinyclip_train_step_fn`). A DARTS or NAS-Bench-201 search
network runs at `speed_test.search_alphas` (`--train`: the searcher's
weight step); a network built from a genotype takes
`speed_test.genotype_kwargs`'s example. A detector runs
`speed_test.detector_forward_fn` (`--decode`: with its decode and host
NMS) or, with `--train`, `speed_test.detector_train_step_fn`;
`--img-size` is its canvas (a DETR's batch carries seeded pixel masks). A
segmenter runs `speed_test.seg_forward_fn` at 1024x2048 or, with
`--train`, `speed_test.seg_train_step_fn` at the 769 crop (`--img-size`
makes both square). A run without a CUDA device fails.
"""
from __future__ import annotations

import argparse
import json
import re
import time

import torch

from cream_tpu_torch.cli.speed_test import card_info

# kind of kernel by name, first match wins
KINDS = [
    ("NCCL collectives", r"nccl"),
    ("K1 window attention fwd", r"window_attention_fwd_(mma_)?kernel"),
    ("K2 window attention bwd", r"window_attention_bwd_(mma_)?kernel|dbias_reduce"),
    ("K4 fused CGA", r"cga_(fused|bf16)_kernel"),
    ("K3 bias attention", r"bias_attention_(mma_)?kernel"),
    ("K5 CGA attention core", r"cga_core_(mma_)?kernel"),
    ("K6 fused MBConv", r"mbconv_(bf16|fp32)_kernel"),
    ("K7 depthwise s1 fwd", r"dwconv_tile_fwd_kernel"),
    ("K7 depthwise s1 bwd", r"dwconv_tile_bwd_kernel<[^>]*true>"),
    ("K8 depthwise weight grad", r"dwconv_tile_bwd_kernel"),      # the same kernel, dx off
    ("K9 depthwise s2 fwd", r"dwconv_s2_fwd_kernel"),
    ("K9 depthwise s2 bwd", r"dwconv_s2_tile_bwd_kernel"),
    ("K7/K8/K9 dw partial sums", r"dwconv_dw_reduce_kernel"),
    ("K10 window relayout", r"partition_kernel|reverse_kernel"),
    ("K11 layout pin", r"copy_kernel<"),
    ("GEMM (cuBLAS)", r"gemm|nvjet|xmma|cutlass|sm90_"),
    ("convolution (cuDNN)", r"conv|cudnn|implicit|dgrad|wgrad|winograd|fft"),
    ("batch norm", r"batch_norm|batchnorm|bn_"),
    ("layer norm", r"layer_norm|layernorm"),
    ("GELU", r"gelu"),
    ("softmax", r"softmax"),
    ("optimizer (foreach / multi-tensor)", r"foreach|multi_tensor"),
    # torch.gather and its backward share one kernel template; the
    # backward's scatter-add carries ReduceAdd (iRPE's bucket gather)
    ("scatter-add (gather backward)", r"scatter.*reduceadd|scatter_add"),
    ("gather", r"gather"),
    ("sort (OHEM)", r"radix|sort"),
    ("reductions", r"reduce"),
    ("copies and casts", r"copy|cat|index|gather|scatter|transpose|permute"),
    ("elementwise", r"elementwise|vectorized|unrolled"),
]


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, pattern in KINDS:
        if re.search(pattern, low):
            return kind
    return "other"


def _busy_us(intervals: list[tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    total, cur_start, cur_end = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_end is None or s > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = s, e
        else:
            cur_end = max(cur_end, e)
    if cur_end is not None:
        total += cur_end - cur_start
    return total


def profile(fn, steps: int = 5, warmup: int = 3, top: int = 25, ranges=()) -> dict:
    """Profile `steps` calls of `fn` (after `warmup` untimed ones) on the
    current CUDA device; times in ms per call. `ranges` names
    `torch.profiler.record_function` ranges (the data-parallel step's
    "grad_all_reduce" and "global_batch_norm"): `ranges_ms` gives the device
    time of the kernels each launched, per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler recorded no device kernels")
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    by_kind: dict[str, float] = {}
    for name, us in by_name.items():
        by_kind[kind_of(name)] = by_kind.get(kind_of(name), 0.0) + us
    device_ms = _busy_us([(e.time_range.start, e.time_range.end)
                          for e in kernels]) / 1e3 / steps
    per = lambda us: us / 1e3 / steps
    # the ranges' host events (each range also has a device-side annotation
    # of the same name, which would count its span a second time)
    in_range = {name: sum(e.device_time_total for e in prof.events()
                          if e.name == name and e.device_type == DeviceType.CPU)
                for name in ranges}
    return {
        "wall_ms": wall_ms, "device_ms": device_ms,
        "idle_share": 1.0 - device_ms / wall_ms,
        "launches": len(kernels) / steps,
        "by_kind_ms": {k: per(v) for k, v in sorted(by_kind.items(), key=lambda kv: -kv[1])},
        "top_kernels_ms": {n[:90]: per(v) for n, v in
                           sorted(by_name.items(), key=lambda kv: -kv[1])[:top]},
        "ranges_ms": {name: per(us) for name, us in in_range.items()},
    }


def use_plain_attention(model: torch.nn.Module) -> None:
    """Swap every attention kernel of `model` for its plain version."""
    from cream_tpu_torch.models.efficientvit import CascadedGroupAttention
    from cream_tpu_torch.nn.attention import WindowBiasAttention
    from cream_tpu_torch.nn.swin import SwinWindowAttention
    for m in model.modules():
        if isinstance(m, (WindowBiasAttention, SwinWindowAttention)):
            m.use_kernel = False
        elif isinstance(m, CascadedGroupAttention):
            m.attn_kernel = "plain"


def main(argv=None):
    from cream_tpu_torch.cli.speed_test import (DETECTOR_PREFIXES, SEG_CROP, SEG_EVAL_HW,
                                                detector_batch, detector_forward_fn,
                                                detector_train_step_fn, forward_fn,
                                                genotype_kwargs, is_detector, is_segmenter,
                                                is_two_tower, model_kwargs, pair_inputs,
                                                pair_step, seg_batch, seg_forward_fn,
                                                seg_train_step_fn, tinyclip_train_step_fn,
                                                train_step_fn)
    from cream_tpu_torch.models import create_model
    from cream_tpu_torch.zoo.load import seeded_state_dict

    ap = argparse.ArgumentParser()
    ap.add_argument("--models", nargs="+", default=["tiny_vit_21m_224"])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--img-size", type=int, default=None,
                    help="input size (default: the model's own)")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--plain-attention", action="store_true",
                    help="use the plain attention instead of the kernels")
    ap.add_argument("--decode", action="store_true",
                    help="a detector's forward plus its decode (the host's NMS included)")
    ap.add_argument("opts", nargs="*",
                    help="model keyword arguments as key=value (e.g. attn_kernel=core)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_step measures a CUDA device; none is available")
    dtype = getattr(torch, args.dtype)
    kw = model_kwargs(args.opts)
    out = {}
    for name in args.models:
        size = {} if args.img_size is None or name.startswith("cydas") else {
            "canvas" if name.startswith(DETECTOR_PREFIXES) else "img_size": args.img_size}
        model = create_model(name, device="cuda", dtype=dtype, **size, **kw,
                             **genotype_kwargs(name, kw))
        model.load_state_dict(seeded_state_dict(model, 0))
        if args.plain_attention:
            use_plain_attention(model)
        square = None if args.img_size is None else (args.img_size,) * 2
        if is_segmenter(model) and args.train:
            _, fn = seg_train_step_fn(model, args.batch, square or (SEG_CROP,) * 2, dtype)
        elif is_segmenter(model):
            fn = seg_forward_fn(model, seg_batch(model, args.batch, square or SEG_EVAL_HW,
                                                 dtype)["image"])
        elif is_detector(model) and args.train:
            _, fn = detector_train_step_fn(model, args.batch, dtype)
        elif is_detector(model):
            b = detector_batch(model, args.batch, dtype)
            fn = detector_forward_fn(model, b["image"], args.decode, b.get("pad_mask"))
        elif args.train and is_two_tower(model):
            _, fn = tinyclip_train_step_fn(model, args.batch)
        elif args.train:
            fn = train_step_fn(model, args.batch, model.img_size, dtype)
        elif is_two_tower(model):
            images, text = pair_inputs(model, args.batch, dtype)

            def fn():
                with torch.inference_mode():
                    pair_step(model, images, text)
        else:
            x = torch.randn(args.batch, model.img_size, model.img_size, 3,
                            device="cuda").to(dtype)
            forward = forward_fn(model)

            def fn():
                with torch.inference_mode():
                    forward(x)
        res = profile(fn, args.steps, args.warmup)
        out[name] = res
        print(json.dumps({"model": name, "train": args.train, "decode": args.decode,
                          "batch": args.batch,
                          "dtype": args.dtype, "plain_attention": args.plain_attention,
                          **kw, **res, "card": card_info()}))
    return out


if __name__ == "__main__":
    main()
