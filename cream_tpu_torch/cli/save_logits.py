"""Teacher logits saver for fast distillation: counterpart of
`cream_tpu/cli/save_logits.py` (TinyViT/save_logits.py).

Per epoch: run the teacher over the seeded training set and store each
sample's top-K softmax probabilities, class indices and augmentation seed
in the sparse logits store (`distill.LogitsWriter`), with the store's
recipe (`recipe.json`: what the teacher saw, which the distill trainer
checks). `--check` re-runs the teacher, checks the stored seeds and
reports the value error, the index-difference rate and the tie-aware miss
rate (the reference's --check-saved-logits).

The teacher (any classifier the port registers: Swin, TinyViT,
EfficientViT, or TinyViT's CLIP teacher `clip_vit_large14_224_classifier`)
must have real weights: `--torch-ckpt` (a released-layout .pth; position
tables whose shapes differ are bicubic-remapped; a CLIP teacher's
historical layouts are normalized) or
`--ckpt` (a checkpoint directory the port's trainer wrote);
`--allow-random` takes seeded random weights, for smoke tests only. With
a 22k-class teacher, `--remap-1kto22k` gathers the 1k classes' logits
before the softmax (classes the mapping marks -1 get probability 0). The
seeded pair mixup is applied to the fp32 images, as the distill trainer
replays it.

    python -m cream_tpu_torch.cli.save_logits model.name=swin_base \
        model.num_classes=21841 data.dataset=synthetic data.batch_size=256 \
        --torch-ckpt swin_base_patch4_window7_224_22k.pth \
        --remap-1kto22k imagenet_1kto22k.txt --out ./logits
    python -m cream_tpu_torch.cli.save_logits \
        model.name=clip_vit_large14_224_classifier model.num_classes=21841 \
        data.dataset=synthetic data.batch_size=256 --torch-ckpt <clip_l14_22k>.pth \
        --remap-1kto22k imagenet_1kto22k.txt --out ./logits
    python -m cream_tpu_torch.cli.save_logits --device cpu \
        model.name=swin_tiny model.dtype=float32 data.dataset=synthetic \
        data.batch_size=4 --allow-random --out ./logits
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from cream_tpu_torch.cli.train import build_dataset, model_options
from cream_tpu_torch.core.config import Config
from cream_tpu_torch.data.imagenet import prefetch, train_loader
from cream_tpu_torch.data.mixup import seeded_pair_mixup
from cream_tpu_torch.distill.logits_store import (LogitsReader, LogitsWriter,
                                                  check_saved_logits, write_recipe)
from cream_tpu_torch.distill.pipeline import replay_recipe
from cream_tpu_torch.models import create_model
from cream_tpu_torch.zoo.remap import load_1k_to_22k, remap_22k_to_1k


def teacher_state_dict(cfg: Config, teacher: torch.nn.Module, torch_ckpt, ckpt,
                       allow_random: bool) -> dict:
    if torch_ckpt:
        from cream_tpu_torch.zoo.load import load_for_model
        return load_for_model(teacher, torch_ckpt)
    if ckpt:
        from cream_tpu_torch.core.checkpoint import restore_params
        return restore_params(ckpt)
    if allow_random:
        from cream_tpu_torch.zoo.load import seeded_state_dict
        return seeded_state_dict(teacher, cfg.train.seed)
    raise SystemExit(
        "refusing to save logits from a RANDOM-init teacher: pass "
        "--torch-ckpt or --ckpt (or --allow-random for smoke tests only). "
        "Random teacher logits would silently poison distillation.")


def make_teacher_probs(cfg: Config, teacher: torch.nn.Module, dtype: torch.dtype,
                       mapping: torch.Tensor | None):
    """probs(images, seeds) -> (B, C) fp32 softmax probabilities of the
    teacher on the device: the seeded pair mixup on the fp32 images, the
    cast to the compute dtype, the teacher in eval mode, the 22k -> 1k
    remap, an fp32 softmax."""
    mixing = cfg.aug.mixup > 0 or cfg.aug.cutmix > 0

    def probs(images: torch.Tensor, seeds: np.ndarray) -> torch.Tensor:
        with torch.inference_mode():
            if mixing:
                zeros = torch.zeros(images.shape[0], dtype=torch.int64, device=images.device)
                images, _ = seeded_pair_mixup(
                    seeds, images, zeros, 1, cfg.aug.mixup, cfg.aug.cutmix,
                    cfg.aug.mixup_switch_prob, cfg.aug.label_smoothing)
            logits = teacher(images.to(dtype))
            if mapping is not None:
                logits = remap_22k_to_1k(logits, mapping)
            return torch.softmax(logits.float(), -1)

    return probs


def _sync(device: torch.device) -> float:
    """The host clock (ms) after the device's queued work is done."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter() * 1e3


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cfg", default=None)
    ap.add_argument("--out", default="teacher_logits")
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--torch-ckpt", default=None,
                    help="released-layout .pth teacher checkpoint")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory written by this package's trainer")
    ap.add_argument("--remap-1kto22k", default=None,
                    help="imagenet_1kto22k.txt: remap 22k teacher logits to 1k")
    ap.add_argument("--allow-random", action="store_true",
                    help="smoke tests only: seeded random teacher weights")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("opts", nargs="*")
    args = ap.parse_args(argv)
    cfg = Config.from_yaml(args.cfg, args.opts)
    device = torch.device(args.device)
    dtype = getattr(torch, cfg.model.dtype)
    teacher = create_model(cfg.model.name, num_classes=cfg.model.num_classes,
                           device=device, dtype=dtype, img_size=cfg.model.img_size,
                           **model_options(cfg))
    teacher.load_state_dict(teacher_state_dict(cfg, teacher, args.torch_ckpt, args.ckpt,
                                               args.allow_random))
    teacher.eval()
    ds = build_dataset(cfg)
    K = cfg.distill.logits_topk
    num_out_classes = cfg.model.num_classes
    mapping = None
    if args.remap_1kto22k:
        mapping = torch.from_numpy(load_1k_to_22k(args.remap_1kto22k)).to(device)
        num_out_classes = int(mapping.shape[0])
    probs_fn = make_teacher_probs(cfg, teacher, dtype, mapping)
    recipe = replay_recipe(cfg)

    summaries = []
    for epoch in range(args.epochs):
        batches = prefetch(train_loader(ds, cfg.data.batch_size, epoch, cfg.train.seed,
                                        cfg.data.num_workers))
        if args.check:
            reader = LogitsReader(args.out, epoch)
            seen = {"max_err": 0.0, "diff": 0.0, "n": 0}

            def checked(batches=batches, reader=reader, seen=seen):
                for batch in batches:
                    probs = probs_fn(torch.from_numpy(batch["image"]).to(device),
                                     batch["seed"])
                    vals, idxs = probs.topk(K, dim=-1)
                    sv, si, ss = reader.read_batch(batch["index"])
                    if not np.array_equal(ss, batch["seed"]):
                        raise ValueError(f"epoch {epoch}: the stored augmentation seeds "
                                         f"differ from the loader's")
                    vals, idxs = vals.cpu().numpy(), idxs.cpu().numpy()
                    seen["max_err"] = max(seen["max_err"], float(np.abs(vals - sv).max()))
                    seen["diff"] += float((idxs != si).mean()) * len(sv)
                    seen["n"] += len(sv)
                    yield {"index": batch["index"], "image": probs.cpu().numpy()}

            stats = check_saved_logits(reader, lambda p: p, checked())
            reader.close()
            summary = {"epoch": epoch, "n": seen["n"], "value_max_err": seen["max_err"],
                       "index_diff_rate": seen["diff"] / max(seen["n"], 1),
                       "index_miss_rate": stats["index_miss_rate"],
                       "value_abs_err": stats["value_abs_err"]}
            print(f"epoch {epoch}: value max err {summary['value_max_err']:.4g}, index "
                  f"diff rate {summary['index_diff_rate']:.4g}, tie-aware index miss "
                  f"rate {summary['index_miss_rate']:.4g} over {summary['n']}")
        else:
            write_recipe(args.out, recipe)
            writer = LogitsWriter(args.out, epoch, len(ds), K, num_out_classes)
            ms = {k: [] for k in ("upload", "teacher", "topk", "transfer", "pack_write")}
            t_start = _sync(device)
            for batch in batches:
                t0 = time.perf_counter() * 1e3
                images = torch.from_numpy(batch["image"]).to(device)
                t1 = _sync(device)
                probs = probs_fn(images, batch["seed"])
                t2 = _sync(device)
                vals, idxs = probs.topk(K, dim=-1)
                t3 = _sync(device)
                vals, idxs = vals.cpu().numpy(), idxs.cpu().numpy()
                t4 = time.perf_counter() * 1e3
                writer.write_batch(batch["index"], batch["seed"], vals, idxs)
                t5 = time.perf_counter() * 1e3
                for k, a, b in (("upload", t0, t1), ("teacher", t1, t2), ("topk", t2, t3),
                                ("transfer", t3, t4), ("pack_write", t4, t5)):
                    ms[k].append(b - a)
            wall = time.perf_counter() * 1e3 - t_start
            writer.close()
            n = len(ms["teacher"]) * cfg.data.batch_size
            summary = {"epoch": epoch, "records": n, "native": writer.native,
                       "batch": cfg.data.batch_size, "wall_ms": wall, "ms": ms}
            med = {k: float(np.median(v[1:] if len(v) > 1 else v)) for k, v in ms.items()}
            print(f"epoch {epoch}: wrote {n} records of {len(ds)} to {args.out} in "
                  f"{wall / 1e3:.2f} s; per batch of {cfg.data.batch_size} (median after "
                  f"the first) teacher {med['teacher']:.2f} ms "
                  f"({cfg.data.batch_size / med['teacher'] * 1e3:.1f} img/s), host ms: "
                  f"upload {med['upload']:.2f}, top-K {med['topk']:.2f}, transfer "
                  f"{med['transfer']:.2f}, pack_write {med['pack_write']:.2f} "
                  f"({'native' if writer.native else 'numpy'} codec)")
        summaries.append(summary)
    return summaries


if __name__ == "__main__":
    main()
