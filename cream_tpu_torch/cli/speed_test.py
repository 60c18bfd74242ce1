"""Throughput harness: warmup, then images/s timed with CUDA events.

    python -m cream_tpu_torch.cli.speed_test --models tiny_vit_21m_224 \
        --batch 256 --img-size 224
    python -m cream_tpu_torch.cli.speed_test --train     # train steps/s
    python -m cream_tpu_torch.cli.speed_test --models efficientvit_m5 \
        --batch 512 attn_kernel=plain                    # model keyword arguments
    python -m cream_tpu_torch.cli.speed_test --train --models efficientvit_m5 \
        --batch 512 dw_kernel=fused                      # or wgrad, library
    python -m cream_tpu_torch.cli.speed_test mbconv_kernel=true pin_layouts=true
    python -m cream_tpu_torch.cli.speed_test --models tiny_vit_21m_384 --batch 64
    python -m cream_tpu_torch.cli.speed_test [--train] --models s3_tiny --batch 128
    python -m cream_tpu_torch.cli.speed_test --models tinyclip_vit_39m_16_text_19m \
        clip_resnet50 --batch 256                        # CLIP: image-text pairs/s
    python -m cream_tpu_torch.cli.speed_test --train \
        --models tinyclip_vit_39m_16_text_19m [remat=true]  # TinyCLIP's L0 distill step
    python -m cream_tpu_torch.cli.speed_test [--train] \
        --models deit_small_patch16_224_ctx_product_50_shared_k \
        mini_deit_small_patch16_224 drop_path_rate=0.1   # DeiT-S iRPE-K, Mini-DeiT-S
    python -m cream_tpu_torch.cli.speed_test [--train] --models \
        autoformer_supernet_tiny cream_supernet --batch 128 config=largest  # smallest, seed:N
    python -m cream_tpu_torch.cli.speed_test --models cream_604 cream_481 \
        --batch 256 [dw_kernel=fused]                    # Cream's released childnets

`--train` times full train steps (forward, backward, AdamW update) as the
JAX package's `bench_train_step` does: `adamw(1e-3, weight_decay=0.05)` on
every param with no clipping, random images and int labels, the variant's
drop path, bf16 compute with fp32 params.

A two-tower CLIP model is timed as pairs (`pair_throughput`): NHWC images
and (B, 77) token ids drawn in [0, 49408) from a seeded generator, as the
JAX package's `bench_clip_pair` draws them (over the model's vocabulary), through both towers, and each
iteration consumes both towers' features (their (B, B) similarity
matrix), so the number is pairs/s of the whole model. With `--train` a
two-tower ViT CLIP is timed through TinyCLIP's L0 distillation step
(`tinyclip_train_throughput`, the JAX package's `bench_tinyclip_train`).

A supernet (`autoformer_supernet_*`, `cream_supernet`) is timed at the
fixed config its `config=` option names (`smallest`, `largest`, `seed:N`);
with `--train` through its own step (`nas.supernet_engine.
make_supernet_train_step`, `nas.cream.make_cream_train_step` without KD),
which gives the params off that path zero grads.

`--img-size` defaults to each model's own (384 for tiny_vit_21m_384).
Weights are seeded random (speed does not depend on them). Each result is
printed as one JSON line beside the card's name and power limit. There is no
CPU timing: a run without a CUDA device fails.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch


def card_info() -> str:
    """`name, power.limit` of the current card as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()
    return out[torch.cuda.current_device()].strip()


def throughput(model: torch.nn.Module, batch: int, img_size: int,
               dtype: torch.dtype = torch.bfloat16, n_iters: int = 20,
               warmup: int = 3) -> float:
    """Forward images/s of `model` on its CUDA device: `warmup` untimed
    forwards, then `n_iters` forwards between two CUDA events, under
    torch.inference_mode()."""
    device = next(model.parameters()).device
    if device.type != "cuda":
        raise RuntimeError(f"throughput is measured on a CUDA device, "
                           f"the model is on {device}")
    gen = torch.Generator(device).manual_seed(0)
    x = torch.randn(batch, img_size, img_size, 3, generator=gen,
                    device=device).to(dtype)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.inference_mode():
        for _ in range(warmup):
            model(x)
        start.record()
        for _ in range(n_iters):
            model(x)
        end.record()
        end.synchronize()
    return batch * n_iters / (start.elapsed_time(end) / 1e3)


def is_two_tower(model: torch.nn.Module) -> bool:
    return hasattr(model, "encode_image") and hasattr(model, "encode_text")


def pair_inputs(model: torch.nn.Module, batch: int, dtype: torch.dtype = torch.bfloat16,
                seed: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """A CLIP pair batch on the model's CUDA device: (B, S, S, 3) normal
    images in `dtype` and (B, context_length) token ids drawn over the
    vocabulary ([0, 49408) for every registered CLIP)."""
    device = next(model.parameters()).device
    if device.type != "cuda":
        raise RuntimeError(f"throughput is measured on a CUDA device, "
                           f"the model is on {device}")
    gen = torch.Generator(device).manual_seed(seed)
    s = model.img_size
    images = torch.randn(batch, s, s, 3, generator=gen, device=device).to(dtype)
    text = torch.randint(0, model.token_embedding.num_embeddings,
                         (batch, model.context_length), generator=gen, device=device)
    return images, text


def pair_step(model: torch.nn.Module, images: torch.Tensor, text: torch.Tensor
              ) -> torch.Tensor:
    """One pair forward whose result reads both towers' features: the
    scaled (B, B) image-text similarity."""
    img, txt, scale = model(images, text)
    return scale * img @ txt.T


def pair_throughput(model: torch.nn.Module, batch: int, dtype: torch.dtype = torch.bfloat16,
                    n_iters: int = 20, warmup: int = 3) -> float:
    """Image-text pairs/s of a two-tower CLIP `model` on its CUDA device:
    `warmup` untimed pair forwards, then `n_iters` between two CUDA events,
    under torch.inference_mode(); each forward's similarity matrix is
    summed into a value read after the last, so both towers' outputs are
    consumed."""
    images, text = pair_inputs(model, batch, dtype)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.inference_mode():
        for _ in range(warmup):
            pair_step(model, images, text)
        total = torch.zeros((), device=images.device)
        start.record()
        for _ in range(n_iters):
            total += pair_step(model, images, text).float().sum()
        end.record()
        end.synchronize()
    if not torch.isfinite(total):
        raise RuntimeError("the pair forwards gave a non-finite similarity")
    return batch * n_iters / (start.elapsed_time(end) / 1e3)


def train_step_fn(model: torch.nn.Module, batch: int, img_size: int,
                  dtype: torch.dtype = torch.bfloat16, num_classes: int = 1000):
    """A zero-argument function that runs one train step of `model` (the
    JAX package's `bench_train_step`: `make_train_step` with int labels,
    adamw(1e-3, weight_decay=0.05) on every param, no clipping) on one
    random batch on the model's CUDA device."""
    from cream_tpu_torch.train import TrainState, make_train_step
    from cream_tpu_torch.train.optim import make_adamw

    device = next(model.parameters()).device
    if device.type != "cuda":
        raise RuntimeError(f"throughput is measured on a CUDA device, "
                           f"the model is on {device}")
    gen = torch.Generator(device).manual_seed(1)
    x = torch.randn(batch, img_size, img_size, 3, generator=gen,
                    device=device).to(dtype)
    labels = torch.randint(0, num_classes, (batch,), generator=gen, device=device)
    state = TrainState(model, make_adamw(1e-3, weight_decay=0.05, clip_grad=None))
    data = {"image": x, "label": labels}
    step = supernet_step(model)
    if step is None:
        step = make_train_step()
    return lambda: step(state, data, 3)


def supernet_step(model: torch.nn.Module):
    """A supernet's own train step at the config fixed at its build, as
    `make_train_step`'s step(state, batch, seed) (the params off that path
    get zero grads: `train.steps.supernet_grads`), or None for a fixed
    model."""
    from cream_tpu_torch.models.autoformer import AutoFormerSuper
    from cream_tpu_torch.models.cream import CreamSupernet
    if isinstance(model, AutoFormerSuper):
        from cream_tpu_torch.nas.supernet_engine import make_supernet_train_step
        af_step = make_supernet_train_step()
        return lambda state, batch, seed: af_step(state, batch, model.config, seed)
    if isinstance(model, CreamSupernet):
        from cream_tpu_torch.nas.cream import make_cream_train_step
        cream_step = make_cream_train_step()
        return lambda state, batch, seed: cream_step(state, batch, model.config, None, 0.0,
                                                     False)
    return None


def train_throughput(model: torch.nn.Module, batch: int, img_size: int,
                     dtype: torch.dtype = torch.bfloat16, n_iters: int = 10,
                     warmup: int = 3) -> float:
    """Train images/s of `model` on its CUDA device: `warmup` untimed
    steps of `train_step_fn`, then `n_iters` between two CUDA events."""
    run = train_step_fn(model, batch, img_size, dtype)
    for _ in range(warmup):
        run()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n_iters):
        run()
    end.record()
    end.synchronize()
    return batch * n_iters / (start.elapsed_time(end) / 1e3)


def tinyclip_train_step_fn(model: torch.nn.Module, batch: int, seed: int = 0):
    """(the trainer, a zero-argument function that runs one step): TinyCLIP's
    L0 distillation step (`cli.tinyclip_pipeline.L0Distill`) on `model`'s
    CUDA device as the JAX package's `bench_tinyclip_train` sets it up:
    gates on both towers (hidden, heads, intermediate) from log-alpha 10,
    target sparsity 0.25 over a 1,000-step warmup, Adam 1e-4 on the
    weights and 1e-2 on the gates and multipliers, the contrastive loss at
    weight 1, a frozen teacher copy; one batch of `pair_inputs` in the
    model's compute dtype, the masks' noise from a seeded generator."""
    from cream_tpu_torch.cli.tinyclip_pipeline import L0Distill
    from cream_tpu_torch.models.clip import CLIP
    if not isinstance(model, CLIP):
        raise TypeError(f"TinyCLIP's train step takes a two-tower ViT CLIP, not "
                        f"{type(model).__name__}")
    images, text = pair_inputs(model, batch, model.dtype, seed)
    trainer = L0Distill(model, lr=1e-4, l0_lr=1e-2, target_sparsity=0.25,
                        sparsity_warmup=1000, contrastive_weight=1.0, l0_init_mean=10.0)
    gen = torch.Generator(images.device).manual_seed(seed + 3)
    return trainer, lambda: trainer.step(images, text, generator=gen)


def tinyclip_train_throughput(model: torch.nn.Module, batch: int = 256, n_iters: int = 10,
                              warmup: int = 3) -> dict:
    """Train pairs/s of TinyCLIP's L0 distillation step on `model` (a
    two-tower ViT CLIP on a CUDA device; `tinyclip_train_step_fn`):
    `warmup` untimed steps, then `n_iters` between two CUDA events; the
    peak device memory over the timed steps (weights, teacher, gates and
    both optimizers' slots included); the first step's loss and the
    losses of all steps."""
    _, run = tinyclip_train_step_fn(model, batch)
    losses = [run()[0] for _ in range(warmup)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n_iters):
        losses.append(run()[0])
    end.record()
    end.synchronize()
    losses = [float(v) for v in losses]
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"TinyCLIP train steps gave a non-finite loss: {losses}")
    ms = start.elapsed_time(end) / n_iters
    return {"pairs_per_s": batch / ms * 1e3, "ms_per_step": ms,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "first_loss": losses[0], "losses": losses}


def model_kwargs(opts: list[str]) -> dict:
    """`key=value` words -> keyword arguments for `create_model`, values
    parsed as config overrides are (numbers, booleans, null, else str)."""
    from cream_tpu_torch.core.config import _parse_value
    kw = {}
    for opt in opts:
        key, sep, value = opt.partition("=")
        if not sep:
            raise ValueError(f"model option {opt!r} is not key=value")
        kw[key] = _parse_value(value)
    return kw


def main(argv=None):
    from cream_tpu_torch.models import create_model, list_models
    from cream_tpu_torch.zoo.load import seeded_state_dict

    ap = argparse.ArgumentParser()
    ap.add_argument("--models", nargs="+", default=["tiny_vit_21m_224"])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--img-size", type=int, default=None,
                    help="input size (default: the model's own)")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--train", action="store_true",
                    help="time train steps instead of forwards")
    ap.add_argument("opts", nargs="*",
                    help="model keyword arguments as key=value (e.g. attn_kernel=plain)")
    args = ap.parse_args(argv)
    dtype = getattr(torch, args.dtype)
    kw = model_kwargs(args.opts)
    results = {}
    for name in args.models:
        if name not in list_models():
            print(f"skip unknown model {name}")
            continue
        size = {} if args.img_size is None else {"img_size": args.img_size}
        model = create_model(name, device=args.device, dtype=dtype, **size, **kw)
        model.load_state_dict(seeded_state_dict(model, 0))
        pairs = is_two_tower(model)
        if pairs and args.train:
            ips = tinyclip_train_throughput(model, args.batch, args.iters)["pairs_per_s"]
        elif args.train:
            ips = train_throughput(model, args.batch, model.img_size, dtype,
                                   args.iters)
        elif pairs:
            ips = pair_throughput(model, args.batch, dtype, args.iters)
        else:
            ips = throughput(model, args.batch, model.img_size, dtype, args.iters)
        results[name] = ips
        print(json.dumps({"model": name, "pairs_per_s" if pairs else "img_per_s": ips,
                          "batch": args.batch,
                          "img_size": model.img_size,
                          "dtype": args.dtype, "train": args.train, **kw,
                          "card": card_info()}))
    return results


if __name__ == "__main__":
    main()
