"""COCO-format detection data: the dataset, RLE and polygon masks, and a
loader of static-shape batches.

The port's copy of `cream_tpu/data/coco.py` (iRPE/DETR-with-iRPE/
datasets/coco.py with the eval transform of datasets/transforms.py): parse
instances_*.json, resize keeping the aspect ratio, paste into a fixed
canvas with a padding mask, pad boxes and labels to max_boxes. numpy only;
PIL is imported inside the functions that read or resize images, so the
CLIs' synthetic mode runs without it. `pil_bilinear_resize` is PIL's
bilinear resize of a float image in numpy (Mask R-CNN's mask pasting uses
it without PIL).

Targets follow DETR's conventions: boxes normalized cxcywh relative to the
unpadded image, labels the raw COCO category ids.
"""
from __future__ import annotations

import json
import math
import os
from typing import Iterator

import numpy as np

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


class CocoDetection:
    """Images + per-image (boxes xywh abs, labels, iscrowd) from COCO json."""

    def __init__(self, img_dir: str, ann_file: str):
        self.img_dir = img_dir
        with open(ann_file) as fh:
            coco = json.load(fh)
        self.images = {im["id"]: im for im in coco["images"]}
        self.anns: dict[int, list] = {iid: [] for iid in self.images}
        for a in coco.get("annotations", []):
            if a.get("ignore", 0):
                continue
            self.anns.setdefault(a["image_id"], []).append(a)
        self.ids = sorted(self.images)
        self.categories = sorted(c["id"] for c in coco.get("categories", []))

    def __len__(self):
        return len(self.ids)

    def load(self, i: int):
        """(the RGB PIL image, its target dict)."""
        from PIL import Image
        iid = self.ids[i]
        info = self.images[iid]
        img = Image.open(os.path.join(self.img_dir, info["file_name"]))
        img = img.convert("RGB")
        anns = [a for a in self.anns.get(iid, [])]
        boxes = np.asarray([a["bbox"] for a in anns],
                           np.float32).reshape(-1, 4)
        # clamp like ConvertCocoPolysToMask (xywh -> clipped xyxy -> keep
        # positive-area boxes)
        W, H = img.size
        xyxy = np.concatenate([boxes[:, :2], boxes[:, :2] + boxes[:, 2:]], 1)
        xyxy[:, 0::2] = xyxy[:, 0::2].clip(0, W)
        xyxy[:, 1::2] = xyxy[:, 1::2].clip(0, H)
        keep = (xyxy[:, 2] > xyxy[:, 0]) & (xyxy[:, 3] > xyxy[:, 1])
        labels = np.asarray([a["category_id"] for a in anns], np.int32)
        iscrowd = np.asarray([a.get("iscrowd", 0) for a in anns], np.int32)
        segs = [a.get("segmentation") for a in anns]
        return img, {"image_id": iid, "xyxy": xyxy[keep],
                     "labels": labels[keep], "iscrowd": iscrowd[keep],
                     "segmentation": [s for s, k in zip(segs, keep) if k],
                     "orig_size": (H, W)}


def decode_rle(counts: list, size: tuple[int, int]) -> np.ndarray:
    """Uncompressed COCO RLE -> (H, W) bool; column-major runs starting
    with background (maskUtils.decode semantics for crowd regions)."""
    h, w = size
    flat = np.zeros(h * w, bool)
    pos, val = 0, False
    for c in counts:
        flat[pos:pos + int(c)] = val
        pos += int(c)
        val = not val
    return flat.reshape(w, h).T


def rasterize_instance(seg, out_h: int, out_w: int, scale_x: float,
                       scale_y: float, flip_w: float | None = None
                       ) -> np.ndarray:
    """One COCO `segmentation` -> (out_h, out_w) bool at a scaled canvas.

    Polygons ([[x0,y0,x1,y1,...], ...]) are even-odd scanline-filled at
    pixel centers after the same affine (optional h-flip at original width
    flip_w, then scale) applied to the boxes — the reference rasterizes via
    pycocotools frPyObjects at full resolution then resizes (mmdet
    PolygonMasks); filling directly at target resolution is the same mask up
    to sub-pixel boundary rounding, and the pixel-center rule makes the
    h-flip an exact mirror. Crowd RLEs decode then nearest-subsample."""
    if isinstance(seg, dict):                     # RLE (crowd regions)
        m = decode_rle(seg["counts"], tuple(seg["size"]))
        if flip_w is not None:
            m = m[:, ::-1]
        ys = np.clip((np.arange(out_h) / scale_y).astype(int), 0,
                     m.shape[0] - 1)
        xs = np.clip((np.arange(out_w) / scale_x).astype(int), 0,
                     m.shape[1] - 1)
        return m[np.ix_(ys, xs)]
    out = np.zeros((out_h, out_w), bool)
    for poly in seg or []:
        p = np.asarray(poly, np.float64).reshape(-1, 2)
        if len(p) < 3:
            continue
        if flip_w is not None:
            p[:, 0] = flip_w - p[:, 0]
        p[:, 0] *= scale_x
        p[:, 1] *= scale_y
        out ^= _fill_polygon_even_odd(p, out_h, out_w)
    return out


def _fill_polygon_even_odd(pts: np.ndarray, out_h: int, out_w: int
                           ) -> np.ndarray:
    """Pixel (r, c) is set iff its center (c+.5, r+.5) is inside the polygon
    by the even-odd rule; exactly mirror-symmetric under x -> W - x."""
    x0, y0 = pts[:, 0], pts[:, 1]
    x1, y1 = np.roll(x0, -1), np.roll(y0, -1)
    m = np.zeros((out_h, out_w), bool)
    for r in range(out_h):
        yc = r + 0.5
        cross = (y0 <= yc) != (y1 <= yc)
        if not cross.any():
            continue
        t = (yc - y0[cross]) / (y1[cross] - y0[cross])
        xs = np.sort(x0[cross] + t * (x1[cross] - x0[cross]))
        for i in range(0, len(xs) - 1, 2):
            c0 = max(int(np.ceil(xs[i] - 0.5)), 0)
            c1 = min(max(int(np.ceil(xs[i + 1] - 0.5)), 0), out_w)
            m[r, c0:c1] = True
    return m


def _resize_keep_aspect(img, size: int, max_size: int):
    """RandomResize(size, max_size) semantics (datasets/transforms.py
    get_size_with_aspect_ratio) on a PIL image."""
    from PIL import Image
    w, h = img.size
    short, long = min(h, w), max(h, w)
    if long / short * size > max_size:
        size = int(round(max_size * short / long))
    if (h <= w and h == size) or (w <= h and w == size):
        return img
    if h < w:
        oh, ow = size, int(size * w / h)
    else:
        ow, oh = size, int(size * h / w)
    return img.resize((ow, oh), Image.BILINEAR)


def detection_loader(dataset: CocoDetection, batch_size: int,
                     canvas: tuple[int, int] = (512, 512),
                     size: int = 480, max_size: int = 512,
                     max_boxes: int = 64, train: bool = False,
                     seed: int = 0, epoch: int = 0,
                     with_masks: bool = False,
                     mask_stride: int = 4) -> Iterator[dict]:
    """Static-shape batches:
      image (B, Hc, Wc, 3) normalized, pad_mask (B, Hc, Wc) True=padding,
      boxes (B, max_boxes, 4) normalized cxcywh, labels (B, max_boxes),
      valid (B, max_boxes), image_id (B,), orig_size (B, 2),
      scaled_size (B, 2) — the resized (pre-pad) H, W for post_process.
    Train mode adds a seeded horizontal flip (transforms.RandomHorizontalFlip).
    with_masks adds masks (B, max_boxes, Hc//mask_stride, Wc//mask_stride)
    bool — per-instance masks rasterized at canvas/stride resolution in the
    same frame as the pasted image (Mask R-CNN targets).
    """
    Hc, Wc = canvas
    order = np.arange(len(dataset))
    if train:
        np.random.default_rng(seed + epoch).shuffle(order)

    def one(i: int):
        from PIL import Image
        img, tgt = dataset.load(int(i))
        xyxy = tgt["xyxy"].copy()
        flip_w = None
        if train:
            rng = np.random.default_rng(
                (seed * 1_000_003 + epoch * 7919 + int(i)) % (2 ** 31))
            if rng.random() < 0.5:
                w0 = img.size[0]
                flip_w = float(w0)
                img = img.transpose(Image.FLIP_LEFT_RIGHT)
                xyxy = xyxy[:, [2, 1, 0, 3]] * np.asarray([-1, 1, -1, 1]) \
                    + np.asarray([w0, 0, w0, 0])
        img = _resize_keep_aspect(img, size, max_size)
        w, h = img.size
        sx, sy = w / tgt["orig_size"][1], h / tgt["orig_size"][0]
        xyxy = xyxy * np.asarray([sx, sy, sx, sy], np.float32)
        arr = np.asarray(img, np.float32) / 255.0
        arr = (arr - IMAGENET_MEAN) / IMAGENET_STD
        canvas_img = np.zeros((Hc, Wc, 3), np.float32)
        canvas_img[:h, :w] = arr[:Hc, :Wc]
        mask = np.ones((Hc, Wc), bool)
        mask[:h, :w] = False
        n = min(len(xyxy), max_boxes)
        boxes = np.zeros((max_boxes, 4), np.float32)
        labels = np.zeros(max_boxes, np.int32)
        valid = np.zeros(max_boxes, bool)
        if n:
            cx = (xyxy[:n, 0] + xyxy[:n, 2]) / 2 / w
            cy = (xyxy[:n, 1] + xyxy[:n, 3]) / 2 / h
            bw = (xyxy[:n, 2] - xyxy[:n, 0]) / w
            bh = (xyxy[:n, 3] - xyxy[:n, 1]) / h
            boxes[:n] = np.stack([cx, cy, bw, bh], 1)
            labels[:n] = tgt["labels"][:n]
            valid[:n] = True
        inst_masks = None
        if with_masks:
            mh, mw = Hc // mask_stride, Wc // mask_stride
            inst_masks = np.zeros((max_boxes, mh, mw), bool)
            for j in range(n):
                inst_masks[j] = rasterize_instance(
                    tgt["segmentation"][j], mh, mw,
                    sx / mask_stride, sy / mask_stride, flip_w=flip_w)
        return (canvas_img, mask, boxes, labels, valid, tgt["image_id"],
                np.asarray(tgt["orig_size"], np.int32),
                np.asarray([h, w], np.int32), inst_masks)

    buf = []
    for i in order:
        buf.append(one(i))
        if len(buf) == batch_size:
            cols = list(zip(*buf))
            out = {"image": np.stack(cols[0]), "pad_mask": np.stack(cols[1]),
                   "boxes": np.stack(cols[2]), "labels": np.stack(cols[3]),
                   "valid": np.stack(cols[4]),
                   "image_id": np.asarray(cols[5]),
                   "orig_size": np.stack(cols[6]),
                   "scaled_size": np.stack(cols[7])}
            if with_masks:
                out["masks"] = np.stack(cols[8])
            yield out
            buf = []


def _bilinear_coeffs(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray]:
    """PIL's precompute_coeffs for the bilinear (triangle) filter:
    (first tap (out,), normalized weights (out, taps)) in float64."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    k = np.zeros((out_size, ksize), np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        x = np.arange(xmax)
        w = np.clip(1.0 - np.abs((x + xmin - center + 0.5) * (1.0 / filterscale)), 0.0, None)
        ww = w.sum()
        k[xx, :xmax] = w / ww if ww != 0.0 else w
        first[xx] = xmin
    return first, k


def _resample_axis(a: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One separable pass along `axis` of a 2-D float32 image: float64 sums
    stored as float32, as PIL's 32-bit float resample does."""
    in_size = a.shape[axis]
    first, k = _bilinear_coeffs(in_size, out_size)
    src = np.moveaxis(a, axis, 0).astype(np.float64)
    out = np.zeros((out_size,) + src.shape[1:], np.float64)
    for xx in range(out_size):
        for t in range(k.shape[1]):
            if k[xx, t] != 0.0:
                out[xx] += src[first[xx] + t] * k[xx, t]
    return np.moveaxis(out.astype(np.float32), 0, axis)


def pil_bilinear_resize(a: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """`Image.fromarray(a, mode="F").resize(size, Image.BILINEAR)` of a 2-D
    float32 array, size (w, h), in numpy: the horizontal pass then the
    vertical one, each only where its size changes."""
    w, h = size
    out = np.asarray(a, np.float32)
    if w != out.shape[1]:
        out = _resample_axis(out, w, 1)
    if h != out.shape[0]:
        out = _resample_axis(out, h, 0)
    return out
