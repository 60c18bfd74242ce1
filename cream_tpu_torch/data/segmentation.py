"""Cityscapes-style semantic-segmentation data.

The port's copy of `cream_tpu/data/segmentation.py`
(CDARTS/CDARTS_segmentation/train/dataloader.py TrainPre: random mirror,
random scale, normalize, random crop padded to shape with image 0 / label
255, tools/utils/img_utils.py) over a paired-directory dataset. Every
sample's draws come from a generator seeded with (seed, epoch, index), so a
batch is a function of those alone. numpy only: PIL is imported inside the
functions that read or resize files (images BILINEAR, labels NEAREST), so
the synthetic mode runs without it.
"""
from __future__ import annotations

import os

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
DEFAULT_SCALES = (0.75, 1.0, 1.25, 1.5, 1.75, 2.0)


class SegFolder:
    """Pairs `img_dir/x.{png,jpg,jpeg}` with `lab_dir/x.png` by stem; labels
    are class-index PNGs, 255 = ignore (Cityscapes' trainIds)."""

    def __init__(self, img_dir: str, lab_dir: str):
        exts = (".png", ".jpg", ".jpeg")
        labs = {os.path.splitext(f)[0]: os.path.join(lab_dir, f)
                for f in os.listdir(lab_dir) if f.lower().endswith(".png")}
        self.items = []
        for f in sorted(os.listdir(img_dir)):
            stem, ext = os.path.splitext(f)
            if ext.lower() in exts and stem in labs:
                self.items.append((os.path.join(img_dir, f), labs[stem]))
        if not self.items:
            raise ValueError(f"no paired images under {img_dir} / {lab_dir}")

    def __len__(self) -> int:
        return len(self.items)

    def load(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        """(RGB uint8 (H, W, 3), int32 labels (H, W))."""
        from PIL import Image
        img_p, lab_p = self.items[i]
        img = np.asarray(Image.open(img_p).convert("RGB"), np.uint8)
        lab = np.asarray(Image.open(lab_p), np.uint8)
        if lab.ndim == 3:
            lab = lab[..., 0]
        return img, lab.astype(np.int32)


def _resize_pair(img: np.ndarray, lab: np.ndarray, scale: float):
    """Both scaled by `scale` (sizes rounded): the image BILINEAR, the
    labels NEAREST, as PIL resizes them."""
    h, w = lab.shape
    nh, nw = max(1, int(round(h * scale))), max(1, int(round(w * scale)))
    if (nh, nw) == (h, w):
        return img, lab
    from PIL import Image
    im = Image.fromarray(img).resize((nw, nh), Image.BILINEAR)
    lb = Image.fromarray(lab.astype(np.uint8)).resize((nw, nh), Image.NEAREST)
    return np.asarray(im, np.uint8), np.asarray(lb, np.int32)


def _crop_pad(img: np.ndarray, lab: np.ndarray, crop_hw, rng: np.random.Generator):
    """img_utils.random_crop_pad_to_shape: a uniformly drawn crop, padded
    (centred) to the crop size with image 0 / label 255."""
    ch, cw = crop_hw
    h, w = lab.shape
    top = int(rng.integers(0, max(h - ch, 0) + 1))
    left = int(rng.integers(0, max(w - cw, 0) + 1))
    img = img[top:top + ch, left:left + cw]
    lab = lab[top:top + ch, left:left + cw]
    ph, pw = ch - lab.shape[0], cw - lab.shape[1]
    if ph or pw:
        t, l = ph // 2, pw // 2
        img = np.pad(img, ((t, ph - t), (l, pw - l), (0, 0)))
        lab = np.pad(lab, ((t, ph - t), (l, pw - l)), constant_values=255)
    return img, lab


def _normalize(img: np.ndarray) -> np.ndarray:
    return (img.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD


def seg_train_batches(ds: SegFolder, batch_size: int, crop_hw: tuple,
                      scales: tuple = DEFAULT_SCALES, seed: int = 0, epoch: int = 0,
                      drop_last: bool = True):
    """Shuffled {image (B, H, W, 3) f32, label (B, H, W) i32} batches: the
    order from default_rng((seed, epoch)), each sample's mirror, scale and
    crop from default_rng((seed, epoch, index))."""
    order = np.random.default_rng((seed, epoch)).permutation(len(ds))
    n = len(order) // batch_size if drop_last else -(-len(order) // batch_size)
    for b in range(n):
        imgs, labs = [], []
        for i in order[b * batch_size:(b + 1) * batch_size]:
            rng = np.random.default_rng((seed, epoch, int(i)))
            img, lab = ds.load(int(i))
            if rng.random() < 0.5:
                img, lab = img[:, ::-1], lab[:, ::-1]
            img, lab = _resize_pair(img, lab, float(rng.choice(np.asarray(scales))))
            img, lab = _crop_pad(img, lab, crop_hw, rng)
            imgs.append(_normalize(img))
            labs.append(lab)
        yield {"image": np.stack(imgs), "label": np.stack(labs)}


def seg_eval_batches(ds: SegFolder, batch_size: int, canvas_hw: tuple):
    """Static-shape eval batches: an image larger than the canvas is scaled
    to fit (aspect kept), then padded, image 0 / label 255; the tail batch
    is padded with all-ignore samples."""
    for b in range(-(-len(ds) // batch_size)):
        imgs, labs = [], []
        for i in range(b * batch_size, min((b + 1) * batch_size, len(ds))):
            img, lab = ds.load(i)
            h, w = lab.shape
            s = min(canvas_hw[0] / h, canvas_hw[1] / w)
            if s < 1.0:
                img, lab = _resize_pair(img, lab, s)
            h, w = lab.shape
            imgs.append(np.pad(_normalize(img), ((0, canvas_hw[0] - h),
                                                 (0, canvas_hw[1] - w), (0, 0))))
            labs.append(np.pad(lab, ((0, canvas_hw[0] - h), (0, canvas_hw[1] - w)),
                               constant_values=255))
        while len(imgs) < batch_size:
            imgs.append(np.zeros_like(imgs[0]))
            labs.append(np.full_like(labs[0], 255))
        yield {"image": np.stack(imgs), "label": np.stack(labs)}


def synthetic_seg_batches(batch_size: int, hw: tuple, num_classes: int, n: int,
                          seed: int = 0):
    """`n` smoke batches from default_rng(seed): N(0, 1) images and blocky
    (8x8) random label maps whose first two rows are ignored. The label
    blocks cover the image: ceil(H / 8) x ceil(W / 8) of them, cropped to
    it (the JAX package draws H // 8 x W // 8, the same draws where 8
    divides the size, and a label map smaller than the image where it does
    not, as at the 769 crop)."""
    rng = np.random.default_rng(seed)
    h, w = hw
    for _ in range(n):
        img = rng.standard_normal((batch_size, h, w, 3)).astype(np.float32)
        coarse = rng.integers(0, num_classes, (batch_size, -(-h // 8), -(-w // 8)))
        lab = np.repeat(np.repeat(coarse, 8, 1), 8, 2)[:, :h, :w].astype(np.int32)
        lab[:, :2] = 255
        yield {"image": img, "label": lab}
