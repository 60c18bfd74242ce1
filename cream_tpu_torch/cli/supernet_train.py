"""AutoFormer supernet training CLI on one card: counterpart of
`cream_tpu/cli/supernet_train.py` (AutoFormer/supernet_train.py --mode
super).

    python -m cream_tpu_torch.cli.supernet_train --space tiny \
        data.dataset=synthetic data.batch_size=128 train.epochs=1
    python -m cream_tpu_torch.cli.supernet_train --device cpu --space tiny \
        model.dtype=float32 model.num_classes=10 model.img_size=32 \
        data.img_size=32 data.dataset=synthetic data.batch_size=4 \
        train.epochs=1 train.warmup_epochs=0 output=./af

Every batch trains a uniformly sampled subnet of the one supernet
(`nas.supernet_engine`), AdamW on a warmup + cosine schedule with an
optional EMA (train.ema_decay), optional frozen-teacher KD
(distill.kind=soft|hard with distill.teacher, its weights from
--teacher-torch-ckpt or seeded), a checkpoint after every epoch and
auto-resume from the newest. Data: `data.dataset=synthetic` or an image
folder (`cli.train.build_dataset`), through the JAX CLI's default seeded
random resized crop and flip; one card (data-parallel training waits for
the port's DDP). Weights start from `zoo.load`'s seeded random weights
(train.seed); `model.drop_path_rate` defaults to the supernet's 0.1.
Returns the checkpoint directory, which `cli.search_evolution --ckpt`
reads.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from cream_tpu_torch.cli.train import build_dataset
from cream_tpu_torch.core.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from cream_tpu_torch.core.config import Config
from cream_tpu_torch.data.imagenet import prefetch, train_loader
from cream_tpu_torch.models import create_model
from cream_tpu_torch.models.autoformer import SPACES
from cream_tpu_torch.nas.supernet_engine import make_supernet_train_step, train_supernet_epoch
from cream_tpu_torch.train import TrainState, cosine_schedule, make_adamw
from cream_tpu_torch.zoo.load import load_for_model, seeded_state_dict


def build_teacher(cfg: Config, device, dtype, torch_ckpt: str | None):
    """The frozen teacher's forward (supernet_engine.py:66-71): its weights
    from a released-layout .pth, else seeded (noise: smoke runs only)."""
    teacher = create_model(cfg.distill.teacher, num_classes=cfg.model.num_classes,
                           device=device, dtype=dtype)
    if torch_ckpt:
        teacher.load_state_dict(load_for_model(teacher, torch_ckpt))
    else:
        teacher.load_state_dict(seeded_state_dict(teacher, cfg.train.seed + 1))
        print("WARNING: the teacher has seeded random weights (no --teacher-torch-ckpt): "
              "its KD signal is noise; for smoke tests only")
    teacher.eval()
    return lambda images: teacher(images)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cfg", default=None)
    ap.add_argument("--space", default="tiny", choices=list(SPACES))
    ap.add_argument("--teacher-torch-ckpt", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("opts", nargs="*")
    args = ap.parse_args(argv)
    cfg = Config.from_yaml(args.cfg, args.opts)
    device = torch.device(args.device)
    dtype = getattr(torch, cfg.model.dtype)

    space = SPACES[args.space]
    name = f"autoformer_supernet_{args.space}"
    kw = {} if cfg.model.drop_path_rate is None else {"drop_path_rate": cfg.model.drop_path_rate}
    model = create_model(name, num_classes=cfg.model.num_classes, img_size=cfg.model.img_size,
                         device=device, dtype=dtype, **kw)
    model.load_state_dict(seeded_state_dict(model, cfg.train.seed))
    ds = build_dataset(cfg, train=True)
    steps_per_epoch = max(len(ds) // cfg.data.batch_size, 1)
    sched = cosine_schedule(cfg.train.base_lr, cfg.train.warmup_epochs * steps_per_epoch,
                            steps_per_epoch * cfg.train.epochs, cfg.train.warmup_lr,
                            cfg.train.min_lr)
    tx = make_adamw(sched, cfg.train.weight_decay, clip_grad=cfg.train.clip_grad,
                    params=dict(model.named_parameters()))
    state = TrainState(model, tx, ema_decay=cfg.train.ema_decay)

    ckpt_dir = f"{cfg.output}/{name}/{cfg.tag}/ckpt"
    start_epoch = 0
    if cfg.train.auto_resume and latest_step(ckpt_dir) is not None:
        state, extra, step = restore_checkpoint(ckpt_dir, state)
        start_epoch = (extra or {}).get("epoch", 0) + 1
        print(f"auto-resumed from step {step} (epoch {start_epoch})")

    teacher = None
    if cfg.distill.kind != "none" and cfg.distill.teacher:
        teacher = build_teacher(cfg, device, dtype, args.teacher_torch_ckpt)
    step = make_supernet_train_step(teacher, distill_kind=cfg.distill.kind,
                                    alpha=cfg.distill.alpha, tau=cfg.distill.tau)

    for epoch in range(start_epoch, cfg.train.epochs):
        t0 = time.time()
        batches = ({"image": torch.from_numpy(b["image"]).to(device, dtype),
                    "label": torch.from_numpy(b["label"]).to(device)}
                   for b in prefetch(train_loader(ds, cfg.data.batch_size, epoch,
                                                  cfg.train.seed, cfg.data.img_size,
                                                  cfg.data.num_workers)))
        state, losses = train_supernet_epoch(state, step, batches, space, epoch,
                                             cfg.train.seed)
        print(f"epoch {epoch}: mean loss {np.mean(losses):.4f} ({time.time() - t0:.1f}s)")
        save_checkpoint(ckpt_dir, state.step, state, extra={"epoch": epoch})
    return ckpt_dir


if __name__ == "__main__":
    main()
