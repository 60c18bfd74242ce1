"""Mask R-CNN-EfficientViT training and COCO evaluation (bbox and segm AP):
the reference's second EfficientViT downstream (configs/mask_rcnn_
efficientvit_m4_fpn_1x_coco.py through mmdet's two-stage runner) as one
command. The port of `cream_tpu/cli/train_mask_rcnn.py`, with its flags:
the RPN's assign, sample and loss, the proposals' NMS, the RCNN sampler,
the multi-level RoIAlign, the box and mask heads and all five losses in one
step (`models.mask_rcnn.mask_rcnn_losses`); the samplers' priorities drawn
from a torch.Generator seeded with `--seed + 1`.

Synthetic boxes with rectangle masks on a tiny canvas, on the CPU:

    python -m cream_tpu_torch.cli.train_mask_rcnn --cpu --synthetic --steps 4 \
        --canvas 128 --batch-size 2 --num-classes 6

COCO (masks rasterized from the polygons; PIL reads the images):

    python -m cream_tpu_torch.cli.train_mask_rcnn --coco-img-dir val2017 \
        --coco-ann annotations/instances_val2017.json [--eval-only]

Runs on `--device` (default cuda; `--cpu` is `--device cpu`) in
`--dtype` (default float32). After training it evaluates, as the JAX CLI
does: the decoded detections' masks are pasted with PIL's bilinear resize,
computed in numpy (`data.coco.pil_bilinear_resize`), so no mode needs PIL
but reading COCO images.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from cream_tpu_torch.cli.train_retinanet import (coco_batches, detection_adamw, image_scale,
                                                 synthetic_boxes, to_coco_xywh, to_device)
from cream_tpu_torch.data.coco import pil_bilinear_resize
from cream_tpu_torch.models import create_model
from cream_tpu_torch.models.mask_rcnn import (MASK_STRIDE, mask_rcnn_anchor_levels,
                                              mask_rcnn_anchors, mask_rcnn_decode,
                                              mask_rcnn_losses, rois_flat, rpn_proposals,
                                              sampler_uniforms)
from cream_tpu_torch.train.state import TrainState
from cream_tpu_torch.train.steps import make_loss_step
from cream_tpu_torch.zoo.load import seeded_state_dict


def synthetic_targets(rng: np.random.Generator, batch: int, canvas: int, max_boxes: int,
                      num_classes: int) -> dict:
    """One batch of the JAX CLI's synthetic targets: random boxes and their
    filled rectangles as instance masks at stride 4."""
    ms = canvas // MASK_STRIDE
    boxes, labels, valid, corners = synthetic_boxes(rng, batch, canvas, max_boxes, num_classes,
                                                    min_side=0.15)
    masks = np.zeros((batch, max_boxes, ms, ms), bool)
    for i, (x1, y1, x2, y2) in enumerate(corners):
        for j in range(len(x1)):
            masks[i, j, int(y1[j]) // MASK_STRIDE:int(y2[j]) // MASK_STRIDE,
                  int(x1[j]) // MASK_STRIDE:int(x2[j]) // MASK_STRIDE] = True
    return {"boxes": boxes, "labels": labels, "valid": valid, "masks": masks}


def synthetic_batches(batch: int, canvas: int, max_boxes: int, num_classes: int, n: int,
                      seed: int = 0) -> list[dict]:
    """The JAX CLI's synthetic batches: N(0, 1) images and
    `synthetic_targets`, drawn from default_rng(seed)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        images = rng.standard_normal((batch, canvas, canvas, 3)).astype(np.float32)
        out.append({"image": images,
                    **synthetic_targets(rng, batch, canvas, max_boxes, num_classes)})
    return out


def paste_mask(mask28: np.ndarray, box: np.ndarray, ms: int) -> np.ndarray:
    """A 28x28 sigmoid mask resized to its box at stride-4 canvas resolution
    (PIL's bilinear resize) and thresholded at .5 (mmdet FCNMaskHead.
    get_seg_masks), the JAX CLI's rule."""
    x1, y1, x2, y2 = (box / MASK_STRIDE).tolist()
    w = max(int(round(x2 - x1)), 1)
    h = max(int(round(y2 - y1)), 1)
    resized = pil_bilinear_resize(mask28.astype(np.float32), (w, h))
    out = np.zeros((ms, ms), bool)
    ox, oy = int(round(x1)), int(round(y1))
    ox0, oy0 = max(ox, 0), max(oy, 0)
    sub = resized[oy0 - oy:oy0 - oy + ms - oy0, ox0 - ox:ox0 - ox + ms - ox0]
    out[oy0:oy0 + sub.shape[0], ox0:ox0 + sub.shape[1]] = sub >= 0.5
    return out


@torch.no_grad()
def infer(model, images: torch.Tensor, anchors: torch.Tensor, level_sizes, proposals: int,
          max_dets: int) -> tuple[list[dict], np.ndarray]:
    """Eval forward of a batch: features, proposals, the box head, the
    decode, then the mask head on the detections (padded to max_dets).
    Returns (detections, (B, max_dets, 28, 28) mask probs of each
    detection's class), the class picked on the device (all classes'
    probs of a bs16 batch are 400 MB)."""
    model.eval()
    feats = model.features(images)
    props, _ = rpn_proposals(*model.rpn(feats), anchors, level_sizes, model.canvas,
                             max_per_img=proposals)
    cls, reg = model.roi_bbox(feats, rois_flat(props))
    B, R = props.shape[:2]
    dets = mask_rcnn_decode(cls.reshape(B, R, -1), reg.reshape(B, R, -1, 4), props,
                            model.canvas, max_per_img=max_dets)
    boxes = np.zeros((B, max_dets, 4), np.float32)
    labels = np.zeros((B, max_dets), np.int64)
    for i, d in enumerate(dets):
        n = min(len(d["boxes"]), max_dets)
        boxes[i, :n], labels[i, :n] = d["boxes"][:n], d["labels"][:n]
    logits = model.roi_mask(feats, rois_flat(torch.from_numpy(boxes).to(images.device)))
    logits = logits.reshape(B, max_dets, *logits.shape[1:])
    lab = torch.from_numpy(labels).to(images.device).view(B, max_dets, 1, 1, 1)
    picked = torch.gather(logits, 4, lab.expand(-1, -1, *logits.shape[2:4], 1))[..., 0]
    return dets, torch.sigmoid(picked.float()).cpu().numpy()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="float32", help="compute dtype (params stay fp32)")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--coco-img-dir", default=None)
    ap.add_argument("--coco-ann", default=None)
    ap.add_argument("--model", default="mask_rcnn_efficientvit_m0")
    ap.add_argument("--canvas", type=int, default=512)
    ap.add_argument("--resize", type=int, default=480)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--num-classes", type=int, default=80)
    ap.add_argument("--max-boxes", type=int, default=32)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--rpn-samples", type=int, default=256)
    ap.add_argument("--rcnn-samples", type=int, default=128,
                    help="sampled rois an image (the mmdet config: 512)")
    ap.add_argument("--proposals", type=int, default=256,
                    help="post-NMS proposals kept an image")
    ap.add_argument("--max-dets", type=int, default=100)
    ap.add_argument("--eval-only", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="mask_rcnn_train.json")
    args = ap.parse_args(argv)
    device = torch.device("cpu" if args.cpu else args.device)
    dtype = getattr(torch, args.dtype)

    model = create_model(args.model, num_classes=args.num_classes, canvas=args.canvas,
                         device=device, dtype=dtype)
    model.load_state_dict(seeded_state_dict(model, args.seed))
    anchors = torch.from_numpy(mask_rcnn_anchors(args.canvas)).to(device)
    level_sizes = mask_rcnn_anchor_levels(args.canvas)

    coco = None
    if args.coco_img_dir and args.coco_ann:
        from cream_tpu_torch.data.coco import CocoDetection
        coco = CocoDetection(args.coco_img_dir, args.coco_ann)
        batches = coco_batches(coco, args, train=not args.eval_only, with_masks=True,
                               mask_stride=MASK_STRIDE)
    else:
        batches = synthetic_batches(args.batch_size, args.canvas, args.max_boxes,
                                    args.num_classes, max(2, args.steps // 2), args.seed)
    batches = [to_device(b, device) for b in batches]

    def coco_evaluate():
        from cream_tpu_torch.train.coco_eval import evaluate_detections
        ms = args.canvas // MASK_STRIDE
        gts, dts = {}, {}
        for bi, batch in enumerate(batches):
            dets, probs = infer(model, batch["image"].to(dtype), anchors, level_sizes,
                                args.proposals, args.max_dets)
            B = len(dets)
            for i, det in enumerate(dets):
                iid = int(batch["image_id"][i]) if "image_id" in batch else bi * B + i
                D = len(det["boxes"])
                det_masks = np.zeros((D, ms, ms), bool)
                for d in range(min(D, args.max_dets)):
                    det_masks[d] = paste_mask(probs[i, d], det["boxes"][d], ms)
                sc = image_scale(batch, i)
                dts[iid] = {"boxes": to_coco_xywh(det["boxes"] * sc), "labels": det["labels"],
                            "scores": det["scores"], "masks": det_masks}
                v = batch["valid"][i].cpu().numpy()
                gts[iid] = {"boxes": to_coco_xywh(batch["boxes"][i].cpu().numpy()[v] * sc),
                            "labels": batch["labels"][i].cpu().numpy()[v],
                            "masks": batch["masks"][i].cpu().numpy()[v]}
        bbox = evaluate_detections(gts, dts, max_dets=args.max_dets)
        segm = evaluate_detections(gts, dts, max_dets=args.max_dets, mode="segm",
                                   mask_area_scale=MASK_STRIDE ** 2)
        metrics = {**{f"bbox_{k}": v for k, v in bbox.items()},
                   **{f"segm_{k}": v for k, v in segm.items()}}
        print("COCO eval:", {k: round(v, 4) for k, v in metrics.items()}, flush=True)
        return metrics

    if args.eval_only:
        metrics = coco_evaluate()
        with open(args.out, "w") as f:
            json.dump(metrics, f, indent=2)
        return {"metrics": metrics}

    def loss_fn(model, batch, u_rpn, u_rcnn):
        return mask_rcnn_losses(model, batch["image"].to(dtype), batch["boxes"],
                                batch["labels"], batch["valid"], batch["masks"], anchors,
                                level_sizes, u_rpn, u_rcnn, args.rpn_samples,
                                args.rcnn_samples, args.proposals)

    state = TrainState(model, detection_adamw(model, args.lr))
    step = make_loss_step(loss_fn)
    gen = torch.Generator(device).manual_seed(args.seed + 1)
    history = []
    for i in range(args.steps):
        batch = batches[i % len(batches)]
        u = sampler_uniforms(gen, args.batch_size, anchors.shape[0],
                             args.max_boxes + args.proposals, device)
        state, loss, losses = step(state, batch, *u)
        rec = {"step": i, "total": float(loss), **{k: float(v) for k, v in losses.items()}}
        history.append(rec)
        print(f"step {i}: total {rec['total']:.3f} rpn {rec['rpn_cls']:.3f}/"
              f"{rec['rpn_reg']:.3f} rcnn {rec['cls']:.3f}/{rec['reg']:.3f} mask "
              f"{rec['mask']:.3f} pos {int(rec['num_pos'])}", flush=True)
    if not np.isfinite(history[-1]["total"]):
        raise RuntimeError(f"non-finite loss: {history[-1]}")
    result = {"history": history, "metrics": coco_evaluate()}
    with open(args.out, "w") as f:
        json.dump(result, f, indent=2)
    print(f"wrote {args.out}")
    return result


if __name__ == "__main__":
    main()
