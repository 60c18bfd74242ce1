"""Eval preprocessing constants + config.

Counterpart of `cream_tpu/data/transforms.py`. Resize and crop run on the
host in numpy (`pil_ops.resize_bicubic`, Pillow's bicubic bit for bit),
without Pillow. This module pins the semantics each model family needs for
checkpoint-parity eval:

  * Swin/TinyViT lineage: Resize(shorter=int(256/224*img), bicubic) →
    CenterCrop(img) → Normalize(ImageNet mean/std)
    (TinyViT/data/build.py:157-211)
  * DeiT lineage (AutoFormer, iRPE, EfficientViT, MiniDeiT): same sizes via
    int((256/224)*input) bicubic (iRPE datasets.py:103-105)
  * CLIP: OpenAI constants (TinyCLIP open_clip/transform.py:71-110)
"""
from __future__ import annotations

import dataclasses

import numpy as np

from cream_tpu_torch.data import pil_ops

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class EvalPreprocess:
    resize_shorter: int
    crop: int
    interpolation: str = "bicubic"
    mean: tuple = IMAGENET_MEAN
    std: tuple = IMAGENET_STD


def eval_preprocess_config(img_size: int = 224, crop: bool = True,
                           clip: bool = False) -> EvalPreprocess:
    mean, std = (CLIP_MEAN, CLIP_STD) if clip else (IMAGENET_MEAN, IMAGENET_STD)
    if crop:
        return EvalPreprocess(int(256 / 224 * img_size), img_size,
                              mean=mean, std=std)
    return EvalPreprocess(img_size, img_size, mean=mean, std=std)


def normalize(img: np.ndarray, cfg: EvalPreprocess) -> np.ndarray:
    """img: float32 HWC in [0,1] -> normalized."""
    return (img - np.asarray(cfg.mean, np.float32)) / np.asarray(cfg.std, np.float32)


def resize_size(w: int, h: int, shorter: int) -> tuple:
    """(new_w, new_h) of torchvision F.resize with an int size: shorter side
    = size, longer side TRUNCATED via int(size * long / short)."""
    if w <= h:
        return shorter, int(shorter * h / w)
    return int(shorter * w / h), shorter


def crop_offsets(nw: int, nh: int, crop: int) -> tuple:
    """(left, top) of torchvision F.center_crop: int(round((dim-crop)/2))
    with Python banker's rounding (NOT floor — differs when dim-crop is odd
    with an even half, e.g. 7 -> 4, while floor gives 3)."""
    return (int(round((nw - crop) / 2.0)), int(round((nh - crop) / 2.0)))


def preprocess_pil(img, cfg: EvalPreprocess) -> np.ndarray:
    """An image -> normalized float32 HWC (bicubic shorter-side resize +
    center crop), matching torchvision Resize+CenterCrop semantics exactly
    (size math pinned by tests/test_preprocess_parity.py) and the JAX
    package's PIL pixels bit for bit. `img`: a uint8 array (H, W, 3), or
    any layout `pil_ops.convert_rgb` takes, or a PIL image."""
    if hasattr(img, "convert"):             # a PIL image: its RGB pixels
        img = np.asarray(img.convert("RGB"))
    img = pil_ops.convert_rgb(img)
    h, w = img.shape[:2]
    nw, nh = resize_size(w, h, cfg.resize_shorter)
    img = pil_ops.resize_bicubic(img, (nw, nh))
    left, top = crop_offsets(nw, nh, cfg.crop)
    img = img[top:top + cfg.crop, left:left + cfg.crop]     # inside: nw, nh >= crop
    arr = np.asarray(img, np.float32) / 255.0
    return normalize(arr, cfg)
