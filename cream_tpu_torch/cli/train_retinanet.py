"""RetinaNet-EfficientViT detection training and COCO evaluation: the
reference's EfficientViT downstream (downstream/train.py with
configs/retinanet_efficientvit_m4_fpn_1x_coco.py) as one command, without
mmdet's runner: AdamW (lr 1e-4, wd 0.05, `attention_biases` excluded from
decay, as the config's paramwise_cfg), static-canvas batches, the assign and
loss on the device, native COCO AP. The port of
`cream_tpu/cli/train_retinanet.py`, with its flags.

Synthetic boxes on a tiny canvas, on the CPU (seconds):

    python -m cream_tpu_torch.cli.train_retinanet --cpu --synthetic --steps 4 \
        --canvas 128 --batch-size 2 --num-classes 6

COCO (PIL reads the images):

    python -m cream_tpu_torch.cli.train_retinanet --coco-img-dir val2017 \
        --coco-ann annotations/instances_val2017.json [--eval-only]

Runs on `--device` (default cuda; `--cpu` is `--device cpu`), params in
fp32 and compute in `--dtype` (default float32, as the JAX CLI). Weights
are seeded (`zoo.load.seeded_state_dict` with `--seed`) with the
classifier's bias at its 0.01 prior, as the JAX CLI's init sets it.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from cream_tpu_torch.models import create_model
from cream_tpu_torch.models.retinanet import (PRIOR_BIAS, anchors_per_level, retina_anchors,
                                              retinanet_decode, retinanet_loss)
from cream_tpu_torch.train.optim import AdamW
from cream_tpu_torch.train.state import TrainState
from cream_tpu_torch.train.steps import make_loss_step
from cream_tpu_torch.zoo.load import seeded_state_dict


def synthetic_boxes(rng: np.random.Generator, batch: int, canvas: int, max_boxes: int,
                    num_classes: int, min_side: float = 0.1):
    """The JAX CLI's synthetic targets for one batch: (boxes (B, M, 4) xyxy,
    labels, valid, the per-image box arrays) from `rng`."""
    boxes = np.zeros((batch, max_boxes, 4), np.float32)
    labels = np.zeros((batch, max_boxes), np.int32)
    valid = np.zeros((batch, max_boxes), bool)
    corners = []
    for i in range(batch):
        k = int(rng.integers(1, max_boxes + 1))
        x1 = rng.uniform(0, canvas * 0.6, k)
        y1 = rng.uniform(0, canvas * 0.6, k)
        w = rng.uniform(canvas * min_side, canvas * 0.4, k)
        h = rng.uniform(canvas * min_side, canvas * 0.4, k)
        x2 = np.minimum(x1 + w, canvas - 1)
        y2 = np.minimum(y1 + h, canvas - 1)
        boxes[i, :k] = np.stack([x1, y1, x2, y2], -1)
        labels[i, :k] = rng.integers(0, num_classes, k)
        valid[i, :k] = True
        corners.append((x1, y1, x2, y2))
    return boxes, labels, valid, corners


def synthetic_batches(batch: int, canvas: int, max_boxes: int, num_classes: int, n: int,
                      seed: int = 0) -> list[dict]:
    """`n` numpy batches of N(0, 1) images and random boxes, the JAX CLI's
    draws from default_rng(seed)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        images = rng.standard_normal((batch, canvas, canvas, 3)).astype(np.float32)
        boxes, labels, valid, _ = synthetic_boxes(rng, batch, canvas, max_boxes, num_classes)
        out.append({"image": images, "boxes": boxes, "labels": labels, "valid": valid})
    return out


def coco_batches(coco, args, train: bool, with_masks: bool = False,
                 mask_stride: int = 4) -> list[dict]:
    """The COCO loader's batches with their normalized cxcywh boxes turned
    into absolute xyxy on the canvas (the detectors' targets)."""
    from cream_tpu_torch.data.coco import detection_loader
    out = []
    for b in detection_loader(coco, args.batch_size, canvas=(args.canvas, args.canvas),
                              size=args.resize, max_size=args.canvas, max_boxes=args.max_boxes,
                              train=train, seed=args.seed, with_masks=with_masks,
                              mask_stride=mask_stride):
        cx, cy, w, h = (b["boxes"][..., i] for i in range(4))
        sh, sw = b["scaled_size"][:, 0:1], b["scaled_size"][:, 1:2]
        b["boxes"] = np.stack([(cx - w / 2) * sw, (cy - h / 2) * sh, (cx + w / 2) * sw,
                               (cy + h / 2) * sh], -1).astype(np.float32)
        out.append(b)
    if not out:
        raise SystemExit("no full COCO batches; lower --batch-size")
    return out


def to_device(batch: dict, device) -> dict:
    """The batch's arrays as tensors on `device` (ids and sizes stay numpy)."""
    keep = ("image_id", "orig_size", "scaled_size")
    return {k: v if k in keep else torch.as_tensor(v, device=device) for k, v in batch.items()}


def detection_adamw(model: torch.nn.Module, lr: float) -> AdamW:
    """The configs' optimizer: AdamW(lr, weight_decay=0.05), every param
    decayed but the attention bias tables (paramwise_cfg), no clipping."""
    return AdamW(lr, 0.05, mask={n: "attention_biases" not in n
                                 for n, _ in model.named_parameters()})


def to_coco_xywh(xyxy: np.ndarray) -> np.ndarray:
    return np.concatenate([xyxy[:, :2], xyxy[:, 2:] - xyxy[:, :2]], 1)


def image_scale(batch: dict, i: int) -> np.ndarray:
    """Canvas -> original-image scale of image i (ones for synthetic)."""
    if "scaled_size" not in batch:
        return np.ones(4)
    sh, sw = np.asarray(batch["scaled_size"])[i]
    oh, ow = np.asarray(batch["orig_size"])[i]
    return np.asarray([ow / sw, oh / sh, ow / sw, oh / sh])


def build_model(args, device, dtype) -> torch.nn.Module:
    """--model, or a NAS backbone from --backbone (a released Cream name, a
    JSON Cream arch, or cdarts:<cells.json>)."""
    kw = dict(num_classes=args.num_classes, canvas=args.canvas, device=device, dtype=dtype)
    if not args.backbone:
        return create_model(args.model, **kw)
    if args.backbone.startswith("cdarts:"):
        with open(args.backbone.split(":", 1)[1]) as f:
            return create_model("retinanet_cdarts", genotypes=json.load(f), **kw)
    if args.backbone.endswith(".json"):
        with open(args.backbone) as f:
            return create_model("retinanet_cream", arch=json.load(f), **kw)
    return create_model("retinanet_cream", arch=args.backbone, **kw)


def retinanet_step_loss(anchors: torch.Tensor, num_classes: int):
    """loss_fn(model, batch) for `make_loss_step`: focal + L1."""
    def loss_fn(model, batch):
        cls, reg = model(batch["image"])
        losses = retinanet_loss(cls, reg, anchors, batch["boxes"], batch["labels"],
                                batch["valid"], num_classes)
        return losses["loss_cls"] + losses["loss_bbox"], losses
    return loss_fn


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="float32", help="compute dtype (params stay fp32)")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--coco-img-dir", default=None)
    ap.add_argument("--coco-ann", default=None)
    ap.add_argument("--model", default="retinanet_efficientvit_m0")
    ap.add_argument("--backbone", default=None,
                    help="NAS-searched backbone instead of --model: a released Cream name "
                         "(cream_14..cream_604), a JSON file with a flat/per-stage Cream arch, "
                         "or 'cdarts:<cells.json>' with per-group genotypes")
    ap.add_argument("--canvas", type=int, default=512)
    ap.add_argument("--resize", type=int, default=480)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--num-classes", type=int, default=80)
    ap.add_argument("--max-boxes", type=int, default=32)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--eval-only", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="retinanet_train.json")
    args = ap.parse_args(argv)
    device = torch.device("cpu" if args.cpu else args.device)
    dtype = getattr(torch, args.dtype)

    model = build_model(args, device, dtype)
    model.load_state_dict(seeded_state_dict(model, args.seed))
    with torch.no_grad():
        model.bbox_head.retina_cls.bias.fill_(PRIOR_BIAS)
    anchors = torch.from_numpy(retina_anchors(args.canvas)).to(device)
    level_sizes = anchors_per_level(args.canvas)

    coco = None
    if args.coco_img_dir and args.coco_ann:
        from cream_tpu_torch.data.coco import CocoDetection
        coco = CocoDetection(args.coco_img_dir, args.coco_ann)
        batches = coco_batches(coco, args, train=not args.eval_only)
    else:
        batches = synthetic_batches(args.batch_size, args.canvas, args.max_boxes,
                                    args.num_classes, max(2, args.steps // 2), args.seed)
    batches = [to_device(b, device) for b in batches]

    def coco_evaluate():
        from cream_tpu_torch.train.coco_eval import evaluate_detections
        gts, dts = {}, {}
        model.eval()
        for bi, batch in enumerate(batches):
            with torch.no_grad():
                cls, reg = model(batch["image"].to(dtype))
            dets = retinanet_decode(cls, reg, anchors, level_sizes)
            B = len(dets)
            for i, d in enumerate(dets):
                iid = int(batch["image_id"][i]) if "image_id" in batch else bi * B + i
                sc = image_scale(batch, i)
                dts[iid] = {"boxes": to_coco_xywh(d["boxes"] * sc), "labels": d["labels"],
                            "scores": d["scores"]}
                v = batch["valid"][i].cpu().numpy()
                gts[iid] = {"boxes": to_coco_xywh(batch["boxes"][i].cpu().numpy()[v] * sc),
                            "labels": batch["labels"][i].cpu().numpy()[v]}
        metrics = evaluate_detections(gts, dts)
        print("COCO eval:", {k: round(v, 4) for k, v in metrics.items()}, flush=True)
        return metrics

    if args.eval_only:
        metrics = coco_evaluate()
        with open(args.out, "w") as f:
            json.dump(metrics, f, indent=2)
        return {"metrics": metrics}

    state = TrainState(model, detection_adamw(model, args.lr))
    step = make_loss_step(retinanet_step_loss(anchors, args.num_classes))
    history = []
    for i in range(args.steps):
        batch = batches[i % len(batches)]
        state, loss, losses = step(state, {**batch, "image": batch["image"].to(dtype)})
        rec = {"step": i, "total": float(loss), "loss_cls": float(losses["loss_cls"]),
               "loss_bbox": float(losses["loss_bbox"]), "num_pos": int(losses["num_pos"])}
        history.append(rec)
        print(f"step {i}: total {rec['total']:.3f} cls {rec['loss_cls']:.3f} "
              f"bbox {rec['loss_bbox']:.3f} pos {rec['num_pos']}", flush=True)
    if not np.isfinite(history[-1]["total"]):
        raise RuntimeError(f"non-finite loss: {history[-1]}")
    result = {"history": history}
    if coco is not None or args.synthetic:
        result["metrics"] = coco_evaluate()
    with open(args.out, "w") as f:
        json.dump(result, f, indent=2)
    print(f"wrote {args.out}")
    return result


if __name__ == "__main__":
    main()
