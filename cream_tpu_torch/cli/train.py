"""Classification training CLI, on one card or data-parallel over several:
counterpart of `cream_tpu/cli/train.py`.

    python -m cream_tpu_torch.cli.train model.name=tiny_vit_21m_224 \
        data.dataset=synthetic data.batch_size=256 train.epochs=1
    python -m cream_tpu_torch.cli.train model.name=tiny_vit_21m_224 \
        data.dataset=imagenet data.data_path=/data/imagenet data.batch_size=256
    python -m cream_tpu_torch.cli.train --device cpu model.dtype=float32 \
        model.name=tiny_vit_5m_224 model.img_size=64 data.img_size=64 \
        data.dataset=synthetic data.batch_size=2 train.epochs=1 \
        train.warmup_epochs=0
    python -m cream_tpu_torch.cli.train model.name=efficientvit_m0 \
        data.dataset=synthetic train.epochs=1 \
        'model.extra={"dw_kernel": "fused"}'
    python -m cream_tpu_torch.cli.train model.name=tiny_vit_21m_224 \
        data.dataset=synthetic data.batch_size=256 train.epochs=1 \
        distill.enabled=true distill.teacher_logits_path=./logits
    torchrun --standalone --nproc_per_node 8 -m cream_tpu_torch.cli.train \
        model.name=tiny_vit_21m_224 data.dataset=imagenet \
        data.data_path=/data/imagenet data.batch_size=128
    torchrun --nproc_per_node 2 -m cream_tpu_torch.cli.train --device cpu \
        model.dtype=float32 model.name=tiny_vit_5m_224 model.img_size=64 \
        data.img_size=64 data.dataset=synthetic data.batch_size=2 \
        train.epochs=1 train.warmup_epochs=0

Data parallelism: under torchrun each process is a rank on its own card
(NCCL; gloo with `--device cpu`, `core.mesh.init_distributed`), reads its
strided slice of every epoch (`shard=(rank, world)`: `data.batch_size`
rows a step, so the global batch is `data.batch_size` x world), mixes its
own rows with the shared mixup draws, and runs the data-parallel step
(`train.steps`: global BatchNorm moments and draws, averaged grads), which
is the one-card step on the global batch; an epoch is the rank slice's
`len // world // data.batch_size` steps. Rank 0 alone logs and writes the
checkpoints; every rank restores them on resume; the eval counts are summed
over the ranks.

AdamW on a warmup + cosine schedule (optionally with gradient accumulation
and an EMA of the params), mixup/cutmix targets (or one-hot targets without
smoothing when both are off), repeated augmentation (`aug.repeated_aug`), a
NaN-loss budget, an eval pass and a checkpoint after every epoch, and
auto-resume from the newest checkpoint. Data: `data.dataset=synthetic`, or
an ImageNet-style folder (`data.data_path` holding `train/` and `val/`
class folders, or `train.zip` and `val.zip`); training images go through
the JAX trainer's seeded recipe (random resized crop, flip, RandAugment or
colour jitter, random erasing; `aug.*`), eval images through its resize
and centre crop, Pillow's pixels computed in numpy. Weights start from
`zoo.load`'s seeded random weights (`train.seed`).

Fast distillation (`distill.enabled` with `distill.teacher_logits_path`, a
store `cli.save_logits` wrote): each epoch reads the stored top-K of its
batches, checks the stored augmentation seeds against the loader's (which
then runs without repeated augmentation, as the JAX trainer's does), replays
the seeded pair mixup on the compute-dtype images and trains on the dense
teacher distribution (`distill.pipeline.make_distill_train_step`). A store
whose recipe (`recipe.json`) differs from this run's is refused.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import time

import numpy as np
import torch
import torch.nn.functional as F

from cream_tpu_torch.core import mesh
from cream_tpu_torch.core.checkpoint import (AsyncCheckpointer, latest_step,
                                             restore_checkpoint)
from cream_tpu_torch.core.config import Config
from cream_tpu_torch.data.det_aug import make_train_transform, train_aug_config
from cream_tpu_torch.data.imagenet import (ImageFolder, SyntheticDataset, ZipImageFolder,
                                           eval_loader, prefetch, train_loader)
from cream_tpu_torch.data.mixup import mixup_cutmix, seeded_pair_mixup
from cream_tpu_torch.distill.logits_store import LogitsReader, check_recipe
from cream_tpu_torch.distill.pipeline import make_distill_train_step, replay_recipe
from cream_tpu_torch.models import create_model
from cream_tpu_torch.models.registry import accepts
from cream_tpu_torch.ops import window_attention
from cream_tpu_torch.train import (MetricLogger, TrainState, cosine_schedule,
                                   make_adamw, make_eval_step, make_train_step,
                                   topk_accuracy_counts)
from cream_tpu_torch.train.losses import soft_target_ce
from cream_tpu_torch.train.metrics import global_counts
from cream_tpu_torch.train.optim import MultiSteps
from cream_tpu_torch.zoo.load import seeded_state_dict


def build_train_transform(cfg: Config):
    """The full seeded augmentation recipe of the config (shared by the train
    and save_logits CLIs so teacher and student see identical pixels)."""
    return make_train_transform(train_aug_config(cfg))


def build_dataset(cfg: Config, train: bool):
    """`data.dataset=synthetic`, else the `train` or `val` split under
    `data.data_path`: `<split>.zip` (or a path ending in .zip) as a
    ZipImageFolder, a directory as an ImageFolder."""
    if cfg.data.dataset == "synthetic":
        return SyntheticDataset(n=max(4 * cfg.data.batch_size, 64),
                                img_size=cfg.data.img_size,
                                num_classes=cfg.model.num_classes)
    p = os.path.join(cfg.data.data_path, "train" if train else "val")
    if p.endswith(".zip") or os.path.isfile(p + ".zip"):
        return ZipImageFolder(p if p.endswith(".zip") else p + ".zip")
    return ImageFolder(p)


def steps_per_epoch(num_samples: int, batch_size: int, world: int = 1) -> int:
    """The steps of an epoch: the batches of one rank's slice of the epoch
    (`data.imagenet.train_loader` with `shard`), at least 1."""
    return max(num_samples // world // batch_size, 1)


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


def open_store(cfg: Config, epoch: int, num_samples: int) -> LogitsReader:
    """The distillation store's reader for `epoch`, checked against the run:
    its classes are the model's and it holds a record per sample."""
    reader = LogitsReader(cfg.distill.teacher_logits_path, epoch)
    if (reader.num_classes, reader.num_samples) != (cfg.model.num_classes, num_samples):
        reader.close()
        raise ValueError(
            f"logits store {cfg.distill.teacher_logits_path}: {reader.num_classes} "
            f"classes, {reader.num_samples} samples; this run has "
            f"{cfg.model.num_classes} classes, {num_samples} samples")
    return reader


def distill_batch(cfg: Config, batch: dict, reader: LogitsReader, device,
                  dtype: torch.dtype) -> dict:
    """The distill step's batch for a loader batch: the stored top-K of its
    samples, after checking the stored augmentation seeds against the
    loader's, and its images in the compute dtype with the save_logits
    pass's seeded pair mixup replayed on them (an fp32 mix, the fp32 lambda
    promoting it, then cast: the JAX trainer's rounding point)."""
    vals, idxs, seeds = reader.read_batch(batch["index"])
    if not np.array_equal(seeds, batch["seed"]):
        raise ValueError("the stored augmentation seeds diverge from the loader's")
    images = torch.from_numpy(batch["image"]).to(device, dtype)
    if cfg.aug.mixup > 0 or cfg.aug.cutmix > 0:
        images, _ = seeded_pair_mixup(
            seeds, images, torch.zeros(len(seeds), dtype=torch.int64), 1,
            cfg.aug.mixup, cfg.aug.cutmix, cfg.aug.mixup_switch_prob,
            cfg.aug.label_smoothing)
    return {"image": images.to(dtype), "topk_values": torch.from_numpy(vals).to(device),
            "topk_indices": torch.from_numpy(idxs).to(device)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cfg", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("opts", nargs="*")
    args = ap.parse_args(argv)
    cfg = Config.from_yaml(args.cfg, args.opts)
    distill = cfg.distill.enabled
    if distill:
        if not cfg.distill.teacher_logits_path:
            raise NotImplementedError(
                "distill.enabled without distill.teacher_logits_path: distillation "
                "from a live teacher is not implemented (nor in the JAX trainer); "
                "save the teacher's logits with cli.save_logits and pass the store")
        check_recipe(cfg.distill.teacher_logits_path, replay_recipe(cfg))
    multi = mesh.init_distributed(args.device)
    # this rank's strided slice of every epoch (DistributedSampler's role);
    # the global order and seeds do not depend on the rank count
    dshard = (mesh.rank(), mesh.world_size()) if multi else None
    main_rank = mesh.is_main_process()
    log = print if main_rank else (lambda *a, **k: None)
    device = mesh.local_device(args.device)
    dtype = getattr(torch, cfg.model.dtype)

    model = create_model(cfg.model.name, num_classes=cfg.model.num_classes,
                         device=device, dtype=dtype, img_size=cfg.model.img_size,
                         **model_options(cfg))
    model.load_state_dict(seeded_state_dict(model, cfg.train.seed))
    mesh.broadcast_module(model)
    train_ds = build_dataset(cfg, train=True)
    eval_ds = build_dataset(cfg, train=False)
    epoch_steps = steps_per_epoch(len(train_ds), cfg.data.batch_size, mesh.world_size())
    total_steps = epoch_steps * cfg.train.epochs

    sched = cosine_schedule(cfg.train.base_lr,
                            cfg.train.warmup_epochs * epoch_steps,
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
        log(f"auto-resumed from step {step} (epoch {start_epoch})")

    train_step = (make_distill_train_step(cfg.model.num_classes) if distill
                  else make_train_step(loss_fn=soft_target_ce))
    eval_step = make_eval_step()
    mixing = cfg.aug.mixup > 0 or cfg.aug.cutmix > 0

    max_acc = 0.0
    nan_count = 0
    scalar_log = None
    if main_rank and (cfg.train.tensorboard or cfg.train.wandb_project):
        from cream_tpu_torch.train.metrics import ScalarLogger
        scalar_log = ScalarLogger(
            logdir=f"{cfg.output}/{cfg.model.name}/{cfg.tag}/tb",
            tensorboard=cfg.train.tensorboard,
            wandb_project=cfg.train.wandb_project or None,
            wandb_config=dataclasses.asdict(cfg) if cfg.train.wandb_project
            else None)
    with contextlib.ExitStack() as stack:
        ckpt = stack.enter_context(AsyncCheckpointer(ckpt_dir)) if main_rank else None
        if scalar_log is not None:
            stack.callback(scalar_log.close)
        for epoch in range(start_epoch, cfg.train.epochs):
            logger = MetricLogger()
            t0 = time.time()
            reader = open_store(cfg, epoch, len(train_ds)) if distill else None
            launches = (window_attention.LAUNCHES, window_attention.BWD_LAUNCHES)
            for i, batch in enumerate(prefetch(train_loader(
                    train_ds, cfg.data.batch_size, epoch, cfg.train.seed,
                    cfg.data.img_size, cfg.data.num_workers,
                    transform=build_train_transform(cfg),
                    repeated_aug=0 if distill else cfg.aug.repeated_aug, shard=dshard))):
                if distill:
                    step_batch = distill_batch(cfg, batch, reader, device, dtype)
                else:
                    images = torch.from_numpy(batch["image"]).to(device, dtype)
                    labels = torch.from_numpy(batch["label"]).to(device)
                    if mixing:
                        mix_gen = torch.Generator().manual_seed(
                            cfg.train.seed * 1_000_003 + epoch * epoch_steps + i)
                        images, targets = mixup_cutmix(
                            mix_gen, images, labels, cfg.model.num_classes,
                            cfg.aug.mixup, cfg.aug.cutmix,
                            cfg.aug.mixup_switch_prob, cfg.aug.label_smoothing)
                    else:
                        targets = F.one_hot(labels.long(), cfg.model.num_classes).float()
                    step_batch = {"image": images, "label": targets}
                state, metrics = train_step(state, step_batch, cfg.train.seed)
                loss_val = float(metrics["loss"])
                if not np.isfinite(loss_val):
                    nan_count += 1
                    log(f"WARNING: non-finite loss ({nan_count}/"
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
                    log(f"epoch {epoch} [{i}/{epoch_steps}] {logger} lr={state.tx.lr():.2e}")

            if reader is not None:
                reader.close()
            log(f"epoch {epoch}: {i + 1} steps, window-attention kernel launches on rank "
                f"{mesh.rank()} K1 {window_attention.LAUNCHES - launches[0]}, "
                f"K2 {window_attention.BWD_LAUNCHES - launches[1]}")
            evals = [eval_step(state, {
                "image": torch.from_numpy(b["image"]).to(device, dtype),
                "label": torch.from_numpy(b["label"]).to(device)})
                for b in eval_loader(eval_ds, cfg.data.batch_size,
                                     cfg.data.img_size, cfg.data.crop,
                                     num_workers=cfg.data.num_workers,
                                     native=cfg.data.native_loader, shard=dshard)]
            acc = topk_accuracy_counts([global_counts(evals, device)])
            max_acc = max(max_acc, acc["acc1"])
            log(f"epoch {epoch} done in {time.time() - t0:.1f}s "
                f"acc@1={acc['acc1']:.3f} acc@5={acc['acc5']:.3f} "
                f"(best {max_acc:.3f})")
            if ckpt is not None:
                ckpt.save(state.step, state,
                          extra={"epoch": epoch, "max_accuracy": max_acc})
    mesh.barrier()      # the last checkpoint is on disk before any rank returns
    return max_acc


if __name__ == "__main__":
    main()
