"""CyDAS semantic-segmentation training and evaluation: the reference's
CDARTS_segmentation/train/train_cydas.py as one command. The port of
`cream_tpu/cli/train_seg.py`, with its flags: SGD momentum 0.9 after weight
decay 5e-4 added to every grad (torch-SGD order), the exponential warmup
then poly(0.9) LR (`poly_warmup_lr`, tools/utils/lr_scheduler.py), OHEM CE
with min_kept = B·H·W // 16 on the main and both auxiliary heads (aux
weight 0.2), the running train mIoU from per-batch intersections and
unions, and whole-image eval mIoU at `--eval-canvas`.

Synthetic blocky labels on the CPU (seconds):

    python -m cream_tpu_torch.cli.train_seg --cpu --synthetic --steps 4 \
        --crop 64 --batch-size 2 --num-classes 7

Cityscapes-format data (images and same-stem trainId label PNGs; PIL reads
them):

    python -m cream_tpu_torch.cli.train_seg --img-dir leftImg8bit/train \
        --lab-dir gtFine/train --epochs 2 [--eval-img-dir ... --eval-lab-dir ...]

Runs on `--device` (default cuda; `--cpu` is `--device cpu`), params in fp32
and compute in `--dtype` (default float32, as the JAX CLI), the depthwise
3x3 sites on `--dw-kernel` (library, or fused: K7). Weights are seeded
(`zoo.load.seeded_state_dict` with `--seed`).
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from cream_tpu_torch.models import create_model
from cream_tpu_torch.nn.layers import DW_KERNELS
from cream_tpu_torch.train.optim import SGD
from cream_tpu_torch.train.segmentation import (batch_intersection_union, cydas_seg_loss,
                                                miou_from_hist, seg_confusion)
from cream_tpu_torch.train.state import TrainState
from cream_tpu_torch.train.steps import make_loss_step
from cream_tpu_torch.zoo.load import seeded_state_dict


def poly_warmup_lr(base_lr: float, warmup_start: float, warmup_iters: int, max_iter: int):
    """Iter_LR_Scheduler's poly mode: warmup_start * f**it below
    `warmup_iters` (f = (base / start) ** (1 / warmup)), then
    base * (1 - t) ** 0.9, t the fraction of the remaining iterations; the
    JAX CLI's float32 arithmetic."""
    def lr(it: int) -> float:
        it = np.float32(it)
        if it < warmup_iters:
            factor = np.float32((base_lr / warmup_start) ** (1.0 / warmup_iters))
            return float(np.float32(warmup_start) * factor ** it)
        t = (it - np.float32(warmup_iters)) / np.float32(max(max_iter - warmup_iters, 1))
        return float(np.float32(base_lr) * np.maximum(np.float32(1.0) - t, np.float32(0.0))
                     ** np.float32(0.9))
    return lr


def seg_sgd(lr, weight_decay: float = 5e-4) -> SGD:
    """`optax.chain(add_decayed_weights(wd), sgd(lr, momentum=0.9))`: the
    decay on every param, added to the grad before the momentum trace."""
    return SGD(lr, momentum=0.9, weight_decay=weight_decay)


def seg_step_loss(min_kept: int, num_classes: int, thresh: float = 0.7,
                  aux_weight: float = 0.2):
    """loss_fn(model, batch) for `make_loss_step`: the three OHEM losses of
    the train-mode forward; metrics the parts and the main prediction's
    per-class intersections and unions (int64)."""
    def loss_fn(model, batch):
        preds = model(batch["image"])
        loss, parts = cydas_seg_loss(preds, batch["label"], min_kept, thresh,
                                     aux_weight=aux_weight)
        with torch.no_grad():
            inter, union = batch_intersection_union(preds[0].argmax(-1), batch["label"],
                                                    num_classes)
        return loss, {**parts, "inter": inter, "union": union}
    return loss_fn


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="float32", help="compute dtype (params stay fp32)")
    ap.add_argument("--dw-kernel", default="library", choices=DW_KERNELS)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--img-dir", default=None)
    ap.add_argument("--lab-dir", default=None)
    ap.add_argument("--eval-img-dir", default=None)
    ap.add_argument("--eval-lab-dir", default=None)
    ap.add_argument("--model", default="cydas_seg")
    ap.add_argument("--num-classes", type=int, default=19)
    ap.add_argument("--crop", type=int, default=769)
    ap.add_argument("--eval-canvas", type=int, nargs=2, default=None,
                    help="eval H W (default: crop x crop)")
    ap.add_argument("--batch-size", type=int, default=12)
    ap.add_argument("--epochs", type=int, default=600)
    ap.add_argument("--steps", type=int, default=None, help="cap total steps (smoke mode)")
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--warmup-start-lr", type=float, default=5e-6)
    ap.add_argument("--warmup-iters", type=int, default=1000)
    ap.add_argument("--weight-decay", type=float, default=5e-4)
    ap.add_argument("--aux-weight", type=float, default=0.2)
    ap.add_argument("--ohem-thresh", type=float, default=0.7)
    ap.add_argument("--eval-only", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="seg_train.json")
    args = ap.parse_args(argv)
    device = torch.device("cpu" if args.cpu else args.device)
    dtype = getattr(torch, args.dtype)

    crop = (args.crop, args.crop)
    model = create_model(args.model, num_classes=args.num_classes, device=device, dtype=dtype,
                         dw_kernel=args.dw_kernel)
    model.load_state_dict(seeded_state_dict(model, args.seed))

    ds = eval_ds = None
    if args.img_dir and args.lab_dir:
        from cream_tpu_torch.data.segmentation import SegFolder
        ds = SegFolder(args.img_dir, args.lab_dir)
        steps_per_epoch = max(len(ds) // args.batch_size, 1)
        if args.eval_img_dir and args.eval_lab_dir:
            eval_ds = SegFolder(args.eval_img_dir, args.eval_lab_dir)
    else:
        args.synthetic = True
        steps_per_epoch = max(2, (args.steps or 4) // 2)
        args.epochs = -(-(args.steps or 4) // steps_per_epoch)
    max_iter = args.epochs * steps_per_epoch
    if args.steps is not None:
        max_iter = min(max_iter, args.steps)
    # the reference's min_kept: batch * H * W // 16 (train_cydas.py:227)
    min_kept = args.batch_size * crop[0] * crop[1] // 16
    lr_fn = poly_warmup_lr(args.lr, args.warmup_start_lr,
                           0 if args.synthetic else args.warmup_iters, max_iter)
    state = TrainState(model, seg_sgd(lr_fn, args.weight_decay))
    step = make_loss_step(seg_step_loss(min_kept, args.num_classes, args.ohem_thresh,
                                        args.aux_weight))

    def tensors(batch: dict) -> dict:
        return {"image": torch.as_tensor(batch["image"], device=device).to(dtype),
                "label": torch.as_tensor(batch["label"], device=device)}

    def run_eval() -> dict:
        from cream_tpu_torch.data.segmentation import seg_eval_batches
        canvas = tuple(args.eval_canvas) if args.eval_canvas else crop
        hist = torch.zeros(args.num_classes, args.num_classes, dtype=torch.long, device=device)
        model.eval()
        for batch in seg_eval_batches(eval_ds, args.batch_size, canvas):
            b = tensors(batch)
            with torch.no_grad():
                pred = model(b["image"])
            hist += seg_confusion(pred.argmax(-1), b["label"], args.num_classes)
        miou, iou = miou_from_hist(hist)
        return {"miou": float(miou), "iou": [round(float(v), 4) for v in iou]}

    if args.eval_only:
        if eval_ds is None:
            raise SystemExit("--eval-only needs --eval-img-dir/--eval-lab-dir")
        metrics = run_eval()
        print("eval:", metrics["miou"], flush=True)
        with open(args.out, "w") as f:
            json.dump(metrics, f, indent=2)
        return metrics

    history, it = [], 0
    inter_sum = np.zeros(args.num_classes, np.float64)
    union_sum = np.zeros(args.num_classes, np.float64)
    for epoch in range(args.epochs):
        if args.synthetic:
            from cream_tpu_torch.data.segmentation import synthetic_seg_batches
            batches = synthetic_seg_batches(args.batch_size, crop, args.num_classes,
                                            steps_per_epoch, args.seed)
        else:
            from cream_tpu_torch.data.segmentation import seg_train_batches
            batches = seg_train_batches(ds, args.batch_size, crop, seed=args.seed, epoch=epoch)
        for batch in batches:
            lr = state.tx.lr()
            state, loss, m = step(state, tensors(batch))
            inter_sum += m["inter"].cpu().numpy()
            union_sum += m["union"].cpu().numpy()
            seen = union_sum > 0
            run_miou = float(np.mean(inter_sum[seen] / union_sum[seen])) if seen.any() else 0.0
            rec = {"step": it, "loss": float(loss), "loss8": float(m["loss8"]), "lr": lr,
                   "train_miou": run_miou}
            history.append(rec)
            print(f"epoch {epoch} it {it}: loss {rec['loss']:.4f} lr {lr:.5f} "
                  f"mIoU {run_miou:.3f}", flush=True)
            it += 1
            if it >= max_iter:
                break
        if it >= max_iter:
            break

    if not np.isfinite(history[-1]["loss"]):
        raise RuntimeError(f"non-finite loss: {history[-1]}")
    result = {"history": history[-20:]}
    if eval_ds is not None:
        result["metrics"] = run_eval()
        print("eval mIoU:", result["metrics"]["miou"], flush=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=2)
    print(f"wrote {args.out}")
    return result


if __name__ == "__main__":
    main()
