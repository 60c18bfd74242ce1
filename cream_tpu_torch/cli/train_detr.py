"""DETR(+iRPE) detection training and COCO evaluation: the reference's
main.py / engine.py (iRPE/DETR-with-iRPE) as one command. The port of
`cream_tpu/cli/train_detr.py`, with its flags and its synthetic batches
(default_rng(seed)).

A step runs one forward under autograd; the criterion
(`train.detection.criterion`) computes each output set's matching cost
under no_grad, assigns on the host (scipy's Hungarian, per image, for the
final and each auxiliary output) and sums CE 1 / L1 5 / GIoU 2 over all of
them; then AdamW(lr, weight decay 1e-4) after `clip_by_global_norm(0.1)`,
in optax's form. (The JAX CLI runs the forward twice, once for the costs
and once under its grad; with no dropout and the same params both give the
same numbers, so one serves.)

Synthetic boxes, the CLI's narrow DETR (a 1-1-1-1 BasicBlock ResNet,
hidden 64, 2 + 2 layers), on the CPU (seconds):

    python -m cream_tpu_torch.cli.train_detr --cpu --synthetic --steps 6 \
        --batch-size 4 --image-size 128 --num-classes 8 \
        --enc-rpe2d rpe-1.9-product-ctx-1-k --out detr_smoke.json

COCO (PIL reads the images; training on static-canvas batches with pixel
masks, then native AP):

    python -m cream_tpu_torch.cli.train_detr --coco-img-dir val2017 \
        --coco-ann annotations/instances_val2017.json --num-classes 91 \
        --num-queries 100 [--eval-only]

Runs on `--device` (default cuda; `--cpu` is `--device cpu`), params in fp32
and compute in `--dtype` (default float32, as the JAX CLI). Weights are
seeded (`zoo.load.seeded_state_dict` with `--seed`).
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from cream_tpu_torch.cli.train_retinanet import to_device
from cream_tpu_torch.models.detr import DETR, parse_enc_rpe2d
from cream_tpu_torch.models.resnet import ResNetBackbone
from cream_tpu_torch.train.detection import criterion, post_process
from cream_tpu_torch.train.optim import AdamW
from cream_tpu_torch.train.state import TrainState
from cream_tpu_torch.train.steps import make_loss_step
from cream_tpu_torch.zoo.load import seeded_state_dict

LOSS_WEIGHTS = {"loss_ce": 1.0, "loss_bbox": 5.0, "loss_giou": 2.0}


def synthetic_targets(rng: np.random.Generator, batch: int, max_boxes: int,
                      num_classes: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One batch's targets, the JAX CLI's draws: 1..max_boxes boxes an image,
    normalized cxcywh (centres in [0.2, 0.8], sides in [0.05, 0.3]),
    labels, valid."""
    nb = rng.integers(1, max_boxes + 1, batch)
    boxes = np.zeros((batch, max_boxes, 4), np.float32)
    labels = np.zeros((batch, max_boxes), np.int64)
    valid = np.zeros((batch, max_boxes), bool)
    for i, k in enumerate(nb):
        cx, cy = rng.uniform(0.2, 0.8, (2, k))
        w, h = rng.uniform(0.05, 0.3, (2, k))
        boxes[i, :k] = np.stack([cx, cy, w, h], -1)
        labels[i, :k] = rng.integers(0, num_classes, k)
        valid[i, :k] = True
    return boxes, labels, valid


def synthetic_batches(batch: int, img: int, max_boxes: int, num_classes: int, n: int,
                      seed: int = 0) -> list[dict]:
    """`n` numpy batches of N(0, 1) images and random boxes from
    default_rng(seed), the JAX CLI's."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        images = rng.standard_normal((batch, img, img, 3)).astype(np.float32)
        boxes, labels, valid = synthetic_targets(rng, batch, max_boxes, num_classes)
        out.append({"image": images, "boxes": boxes, "labels": labels, "valid": valid})
    return out


def detr_step_loss(num_classes: int, eos_coef: float = 0.1):
    """loss_fn(model, batch) for `make_loss_step`: one forward (with the
    batch's `pad_mask` where it has one), the criterion over the final and
    auxiliary outputs; metrics are the final output's losses."""
    def loss_fn(model, batch):
        out = model(batch["image"], batch.get("pad_mask"))
        losses = criterion(out, batch["boxes"], batch["labels"], batch["valid"], num_classes,
                           eos_coef, LOSS_WEIGHTS)
        return losses["total"], {k: losses[k] for k in ("loss_ce", "loss_bbox", "loss_giou")}
    return loss_fn


def detr_adamw(lr: float = 1e-4, clip_norm: float = 0.1) -> AdamW:
    """`optax.chain(clip_by_global_norm(clip_norm), adamw(lr, weight_decay=
    1e-4))`: every param decayed."""
    return AdamW(lr, 1e-4, clip_grad=clip_norm)


def build_model(args, canvas: int, device, dtype) -> DETR:
    """The JAX CLI's DETR: a 1-1-1-1 BasicBlock ResNet, 4 heads, FFN 4x."""
    return DETR(ResNetBackbone((1, 1, 1, 1), "basic", dtype=dtype, device=device),
                num_classes=args.num_classes, num_queries=args.num_queries,
                hidden_dim=args.hidden_dim, nhead=4, num_encoder_layers=args.enc_layers,
                num_decoder_layers=args.dec_layers, dim_feedforward=args.hidden_dim * 4,
                aux_loss=args.aux_loss, rpe_config=parse_enc_rpe2d(args.enc_rpe2d),
                canvas=canvas, dtype=dtype, device=device)


def coco_evaluate(model: DETR, batches: list[dict], dtype) -> dict:
    """Native COCO bbox AP over the batches (engine.py:68 evaluate), boxes
    in the original images' pixels."""
    from cream_tpu_torch.train.coco_eval import evaluate_detections
    gts, dts = {}, {}
    model.eval()
    for batch in batches:
        with torch.no_grad():
            out = model(batch["image"].to(dtype), batch.get("pad_mask"))
        sizes = torch.as_tensor(np.asarray(batch["orig_size"]), dtype=torch.float32,
                                device=out["pred_logits"].device)
        res = post_process({k: out[k].float() for k in ("pred_logits", "pred_boxes")}, sizes)
        for i, iid in enumerate(np.asarray(batch["image_id"])):
            xyxy = res[i]["boxes"].cpu().numpy()
            dts[int(iid)] = {"boxes": np.concatenate([xyxy[:, :2], xyxy[:, 2:] - xyxy[:, :2]], 1),
                             "labels": res[i]["labels"].cpu().numpy(),
                             "scores": res[i]["scores"].cpu().numpy()}
            oh, ow = np.asarray(batch["orig_size"])[i]
            v = batch["valid"][i].cpu().numpy()
            cxcywh = batch["boxes"][i].cpu().numpy()[v]
            xywh = np.concatenate([cxcywh[:, :2] - cxcywh[:, 2:] / 2, cxcywh[:, 2:]], 1)
            gts[int(iid)] = {"boxes": xywh * np.asarray([ow, oh, ow, oh], np.float32),
                             "labels": batch["labels"][i].cpu().numpy()[v]}
    metrics = evaluate_detections(gts, dts)
    print("COCO eval:", {k: round(v, 4) for k, v in metrics.items()}, flush=True)
    return metrics


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="float32", help="compute dtype (params stay fp32)")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--coco-img-dir", default=None, help="COCO images dir (e.g. val2017/)")
    ap.add_argument("--coco-ann", default=None, help="COCO instances_*.json annotations")
    ap.add_argument("--canvas", type=int, default=512,
                    help="fixed square canvas; images are aspect-resized then zero-padded "
                         "with a pixel mask")
    ap.add_argument("--resize", type=int, default=480)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--eval-only", action="store_true")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--image-size", type=int, default=128)
    ap.add_argument("--num-classes", type=int, default=8)
    ap.add_argument("--num-queries", type=int, default=16)
    ap.add_argument("--max-boxes", type=int, default=6)
    ap.add_argument("--hidden-dim", type=int, default=64)
    ap.add_argument("--enc-layers", type=int, default=2)
    ap.add_argument("--dec-layers", type=int, default=2)
    ap.add_argument("--enc-rpe2d", default="rpe-1.9-product-ctx-1-k",
                    help="'' disables RPE (plain DETR)")
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--clip-norm", type=float, default=0.1)
    ap.add_argument("--eos-coef", type=float, default=0.1)
    ap.add_argument("--aux-loss", action="store_true", default=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="detr_train.json")
    args = ap.parse_args(argv)
    device = torch.device("cpu" if args.cpu else args.device)
    dtype = getattr(torch, args.dtype)

    coco = None
    if args.coco_img_dir and args.coco_ann:
        from cream_tpu_torch.data.coco import CocoDetection, detection_loader
        coco = CocoDetection(args.coco_img_dir, args.coco_ann)
        batches = list(detection_loader(
            coco, args.batch_size, canvas=(args.canvas, args.canvas), size=args.resize,
            max_size=args.canvas, max_boxes=args.max_boxes, train=not args.eval_only,
            seed=args.seed))
        if not batches:
            raise SystemExit("COCO dir yielded no full batches; lower --batch-size")
        canvas = args.canvas
    else:
        batches = synthetic_batches(args.batch_size, args.image_size, args.max_boxes,
                                    args.num_classes, max(2, args.steps // 2), args.seed)
        canvas = args.image_size
    batches = [to_device(b, device) for b in batches]
    model = build_model(args, canvas, device, dtype)
    model.load_state_dict(seeded_state_dict(model, args.seed))

    if args.eval_only:
        metrics = coco_evaluate(model, batches, dtype)
        with open(args.out, "w") as f:
            json.dump(metrics, f, indent=2)
        return metrics

    state = TrainState(model, detr_adamw(args.lr, args.clip_norm))
    step = make_loss_step(detr_step_loss(args.num_classes, args.eos_coef))
    history = []
    for i in range(args.steps):
        batch = batches[i % len(batches)]
        state, loss, losses = step(state, {**batch, "image": batch["image"].to(dtype)})
        rec = {"step": i, "total": float(loss),
               **{k: float(losses[k]) for k in ("loss_ce", "loss_bbox", "loss_giou")}}
        history.append(rec)
        print(f"step {i}: total {rec['total']:.3f} ce {rec['loss_ce']:.3f} "
              f"bbox {rec['loss_bbox']:.3f} giou {rec['loss_giou']:.3f}", flush=True)
    if not np.isfinite(history[-1]["total"]):
        raise RuntimeError(f"non-finite loss: {history[-1]}")
    result = {"history": history}
    if coco is not None:
        result["metrics"] = coco_evaluate(model, batches, dtype)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=2)
    print(f"wrote {args.out}; final total {history[-1]['total']:.3f}")
    return result


if __name__ == "__main__":
    main()
