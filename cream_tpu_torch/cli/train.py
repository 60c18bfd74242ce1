"""Classification training CLI on one card: counterpart of
`cream_tpu/cli/train.py`.

    python -m cream_tpu_torch.cli.train model.name=tiny_vit_21m_224 \
        data.dataset=synthetic data.batch_size=256 train.epochs=1
    python -m cream_tpu_torch.cli.train --device cpu model.dtype=float32 \
        model.name=tiny_vit_5m_224 model.img_size=64 data.img_size=64 \
        data.dataset=synthetic data.batch_size=2 train.epochs=1 \
        train.warmup_epochs=0
    python -m cream_tpu_torch.cli.train model.name=efficientvit_m0 \
        data.dataset=synthetic train.epochs=1 \
        'model.extra={"dw_kernel": "fused"}'

AdamW on a warmup + cosine schedule (optionally with gradient accumulation
and an EMA of the params), mixup/cutmix targets (or one-hot targets without
smoothing when both are off), a NaN-loss budget, an eval pass and a
checkpoint after every epoch, and auto-resume from the newest checkpoint.
Data: `data.dataset=synthetic` only; the image-folder datasets and their
augmentation wait for the PIL-based loaders. Teacher distillation
(`distill.enabled`) is not ported. Weights start from `zoo.load`'s seeded
random weights (`train.seed`).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import time

import numpy as np
import torch
import torch.nn.functional as F

from cream_tpu_torch.core.checkpoint import (AsyncCheckpointer, latest_step,
                                             restore_checkpoint)
from cream_tpu_torch.core.config import Config
from cream_tpu_torch.data.imagenet import (SyntheticDataset, eval_loader,
                                           prefetch, train_loader)
from cream_tpu_torch.data.mixup import mixup_cutmix
from cream_tpu_torch.models import create_model
from cream_tpu_torch.models.registry import accepts
from cream_tpu_torch.train import (MetricLogger, TrainState, cosine_schedule,
                                   make_adamw, make_eval_step, make_train_step,
                                   topk_accuracy_counts)
from cream_tpu_torch.train.losses import soft_target_ce
from cream_tpu_torch.train.optim import MultiSteps
from cream_tpu_torch.zoo.load import seeded_state_dict


def build_dataset(cfg: Config):
    if cfg.data.dataset != "synthetic":
        raise NotImplementedError(
            f"data.dataset={cfg.data.dataset!r}: only 'synthetic' is ported; "
            "the image-folder datasets and their augmentation are PIL-based "
            "and wait for a later slice")
    return SyntheticDataset(n=max(4 * cfg.data.batch_size, 64),
                            img_size=cfg.data.img_size,
                            num_classes=cfg.model.num_classes)


def model_options(cfg: Config) -> dict:
    """`model.extra`, with `model.drop_path_rate` when it is set. A model
    whose factory takes no drop path rate (EfficientViT) refuses one."""
    kw = dict(cfg.model.extra)
    if cfg.model.drop_path_rate is not None:
        if not accepts(cfg.model.name, "drop_path_rate"):
            raise ValueError(f"model.drop_path_rate is set, but {cfg.model.name} "
                             f"has no drop path")
        kw["drop_path_rate"] = cfg.model.drop_path_rate
    return kw


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cfg", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("opts", nargs="*")
    args = ap.parse_args(argv)
    cfg = Config.from_yaml(args.cfg, args.opts)
    if cfg.distill.enabled:
        raise NotImplementedError("distillation (distill.enabled) is not "
                                  "ported to cream_tpu_torch yet")
    device = torch.device(args.device)
    dtype = getattr(torch, cfg.model.dtype)

    model = create_model(cfg.model.name, num_classes=cfg.model.num_classes,
                         device=device, dtype=dtype, img_size=cfg.model.img_size,
                         **model_options(cfg))
    model.load_state_dict(seeded_state_dict(model, cfg.train.seed))
    train_ds = eval_ds = build_dataset(cfg)
    steps_per_epoch = max(len(train_ds) // cfg.data.batch_size, 1)
    total_steps = steps_per_epoch * cfg.train.epochs

    sched = cosine_schedule(cfg.train.base_lr,
                            cfg.train.warmup_epochs * steps_per_epoch,
                            total_steps, cfg.train.warmup_lr, cfg.train.min_lr)
    tx = make_adamw(sched, cfg.train.weight_decay,
                    clip_grad=cfg.train.clip_grad,
                    params=dict(model.named_parameters()))
    if cfg.train.accumulation_steps > 1:
        tx = MultiSteps(tx, cfg.train.accumulation_steps)
    state = TrainState(model, tx, ema_decay=cfg.train.ema_decay)

    ckpt_dir = f"{cfg.output}/{cfg.model.name}/{cfg.tag}/ckpt"
    start_epoch = 0
    if cfg.train.auto_resume and latest_step(ckpt_dir) is not None:
        state, extra, step = restore_checkpoint(ckpt_dir, state)
        start_epoch = (extra or {}).get("epoch", 0) + 1
        print(f"auto-resumed from step {step} (epoch {start_epoch})")

    train_step = make_train_step(loss_fn=soft_target_ce)
    eval_step = make_eval_step()
    mixing = cfg.aug.mixup > 0 or cfg.aug.cutmix > 0

    max_acc = 0.0
    nan_count = 0
    scalar_log = None
    if cfg.train.tensorboard or cfg.train.wandb_project:
        from cream_tpu_torch.train.metrics import ScalarLogger
        scalar_log = ScalarLogger(
            logdir=f"{cfg.output}/{cfg.model.name}/{cfg.tag}/tb",
            tensorboard=cfg.train.tensorboard,
            wandb_project=cfg.train.wandb_project or None,
            wandb_config=dataclasses.asdict(cfg) if cfg.train.wandb_project
            else None)
    with contextlib.ExitStack() as stack:
        ckpt = stack.enter_context(AsyncCheckpointer(ckpt_dir))
        if scalar_log is not None:
            stack.callback(scalar_log.close)
        for epoch in range(start_epoch, cfg.train.epochs):
            logger = MetricLogger()
            t0 = time.time()
            for i, batch in enumerate(prefetch(train_loader(
                    train_ds, cfg.data.batch_size, epoch, cfg.train.seed,
                    cfg.data.num_workers))):
                images = torch.from_numpy(batch["image"]).to(device, dtype)
                labels = torch.from_numpy(batch["label"]).to(device)
                if mixing:
                    mix_gen = torch.Generator().manual_seed(
                        cfg.train.seed * 1_000_003 + epoch * steps_per_epoch + i)
                    images, targets = mixup_cutmix(
                        mix_gen, images, labels, cfg.model.num_classes,
                        cfg.aug.mixup, cfg.aug.cutmix,
                        cfg.aug.mixup_switch_prob, cfg.aug.label_smoothing)
                else:
                    targets = F.one_hot(labels.long(), cfg.model.num_classes).float()
                state, metrics = train_step(state, {"image": images, "label": targets},
                                            cfg.train.seed)
                loss_val = float(metrics["loss"])
                if not np.isfinite(loss_val):
                    nan_count += 1
                    print(f"WARNING: non-finite loss ({nan_count}/"
                          f"{cfg.train.nan_budget})")
                    if nan_count > cfg.train.nan_budget:
                        raise FloatingPointError(
                            "NaN-loss budget exhausted — aborting (see "
                            "train.nan_budget)")
                logger.update(**{k: float(v) for k, v in metrics.items()})
                if scalar_log is not None and i % 20 == 0:
                    scalar_log.log(state.step, **{f"train/{k}": float(v)
                                                  for k, v in metrics.items()})
                if i % 50 == 0:
                    print(f"epoch {epoch} [{i}/{steps_per_epoch}] {logger} "
                          f"lr={state.tx.lr():.2e}")

            evals = [eval_step(state, {
                "image": torch.from_numpy(b["image"]).to(device, dtype),
                "label": torch.from_numpy(b["label"]).to(device)})
                for b in eval_loader(eval_ds, cfg.data.batch_size,
                                     cfg.data.num_workers)]
            acc = topk_accuracy_counts(evals)
            max_acc = max(max_acc, acc["acc1"])
            print(f"epoch {epoch} done in {time.time() - t0:.1f}s "
                  f"acc@1={acc['acc1']:.3f} acc@5={acc['acc5']:.3f} "
                  f"(best {max_acc:.3f})")
            ckpt.save(state.step, state,
                      extra={"epoch": epoch, "max_accuracy": max_acc})
    return max_acc


if __name__ == "__main__":
    main()
