"""Deterministic (seed-replayable) training augmentations.

Counterpart of `cream_tpu/data/det_aug.py` (TinyViT/data/augmentation/
aug_random.py:1-61): every sample's augmentation is a pure function of an
int32 seed, so teacher logits saved for epoch e, sample i stay valid when
the student replays seed(e, i). The transforms take uint8 RGB arrays and an
np.random.Generator, make the JAX module's draws in its order and give its
pixels exactly: the Pillow resampling is `pil_ops.resize_bicubic`.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from cream_tpu_torch.data import pil_ops
from cream_tpu_torch.data.auto_augment import RandomErasing, color_jitter, create_augmenter


def sample_seed(base_seed: int, epoch: int, index: int) -> int:
    """Stable per-(epoch, sample) seed (int32, SplitMix-style)."""
    x = (base_seed * 0x9E3779B1 + epoch * 0x85EBCA77 + index * 0xC2B2AE3D)
    x &= 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x7FEB352D) & 0xFFFFFFFF
    x ^= x >> 15
    return int(x & 0x7FFFFFFF)


def rrc_box(W: int, H: int, rng: np.random.Generator, scale=(0.08, 1.0),
            ratio=(3 / 4, 4 / 3)) -> tuple:
    """The (x0, y0, w, h) crop box of torchvision RandomResizedCrop (10
    tries then center fallback)."""
    area = W * H
    for _ in range(10):
        target = area * rng.uniform(*scale)
        log_r = rng.uniform(np.log(ratio[0]), np.log(ratio[1]))
        ar = np.exp(log_r)
        w = int(round(np.sqrt(target * ar)))
        h = int(round(np.sqrt(target / ar)))
        if 0 < w <= W and 0 < h <= H:
            x0 = int(rng.integers(0, W - w + 1))
            y0 = int(rng.integers(0, H - h + 1))
            return x0, y0, w, h
    # fallback: center crop at the clamped aspect
    in_ratio = W / H
    if in_ratio < ratio[0]:
        w, h = W, int(round(W / ratio[0]))
    elif in_ratio > ratio[1]:
        w, h = int(round(H * ratio[1])), H
    else:
        w, h = W, H
    return (W - w) // 2, (H - h) // 2, w, h


def random_resized_crop(img: np.ndarray, rng: np.random.Generator,
                        size: int, scale=(0.08, 1.0),
                        ratio=(3 / 4, 4 / 3)) -> np.ndarray:
    """torchvision RandomResizedCrop semantics (10 tries then center
    fallback), bicubic, on a uint8 HWC array."""
    H, W = img.shape[:2]
    x0, y0, w, h = rrc_box(W, H, rng, scale, ratio)
    return pil_ops.resize_bicubic(img, (size, size), (x0, y0, x0 + w, y0 + h))


def train_transform(img: np.ndarray, seed: int, size: int = 224,
                    mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225),
                    hflip: float = 0.5) -> np.ndarray:
    """Seeded RRC + horizontal flip + normalize -> float32 HWC."""
    rng = np.random.default_rng(seed)
    img = pil_ops.convert_rgb(img)
    img = random_resized_crop(img, rng, size)
    if rng.random() < hflip:
        img = pil_ops.flip_lr(img)
    arr = np.asarray(img, np.float32) / 255.0
    return (arr - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


@dataclasses.dataclass(frozen=True)
class TrainAugConfig:
    """The reference training recipe's aug knobs (timm create_transform args;
    TinyViT/data/build.py, AutoFormer lib/datasets.py)."""
    img_size: int = 224
    hflip: float = 0.5
    scale: tuple = (0.08, 1.0)
    ratio: tuple = (3 / 4, 4 / 3)
    color_jitter: float = 0.4             # applied only when auto_augment off
    auto_augment: str = "rand-m9-mstd0.5-inc1"
    reprob: float = 0.25                  # random erasing probability
    remode: str = "pixel"
    recount: int = 1
    mean: tuple = (0.485, 0.456, 0.406)
    std: tuple = (0.229, 0.224, 0.225)


class TrainTransform:
    """Full deterministic training pipeline: RRC -> hflip -> RandAugment/
    AutoAugment (or color jitter) -> normalize -> random erasing; a pure
    function of (uint8 RGB array, seed) -> float32 HWC (timm order in
    transforms_factory: aa disables color jitter). It pickles as its
    config, so the loaders' worker processes rebuild it."""

    def __init__(self, cfg: TrainAugConfig):
        self.cfg = cfg
        self.augmenter = create_augmenter(
            cfg.auto_augment,
            hparams=dict(translate_const=int(cfg.img_size * 0.45),
                         img_mean=tuple(int(round(255 * m)) for m in cfg.mean)))
        self.eraser = (RandomErasing(cfg.reprob, mode=cfg.remode,
                                     max_count=cfg.recount)
                       if cfg.reprob > 0 else None)
        self.mean = np.asarray(cfg.mean, np.float32)
        self.std = np.asarray(cfg.std, np.float32)

    def __reduce__(self):
        return TrainTransform, (self.cfg,)

    def __call__(self, img: np.ndarray, seed: int) -> np.ndarray:
        cfg = self.cfg
        rng = np.random.default_rng(seed)
        img = pil_ops.convert_rgb(img)
        img = random_resized_crop(img, rng, cfg.img_size, cfg.scale, cfg.ratio)
        if rng.random() < cfg.hflip:
            img = pil_ops.flip_lr(img)
        if self.augmenter is not None:
            img = self.augmenter(img, rng)
        elif cfg.color_jitter > 0:
            img = color_jitter(img, rng, cfg.color_jitter)
        arr = np.asarray(img, np.float32) / 255.0
        arr = (arr - self.mean) / self.std
        if self.eraser is not None:
            arr = self.eraser(arr, rng)
        return arr


def make_train_transform(cfg: TrainAugConfig) -> TrainTransform:
    """The recipe of `cfg` as a function of (uint8 RGB array, seed)."""
    return TrainTransform(cfg)


def train_aug_config(cfg) -> TrainAugConfig:
    """The recipe of a run's config (`data.img_size` and the `aug.*` knobs),
    as the JAX trainer's `build_train_transform` builds it."""
    return TrainAugConfig(
        img_size=cfg.data.img_size, hflip=cfg.aug.hflip,
        color_jitter=cfg.aug.color_jitter, auto_augment=cfg.aug.auto_augment,
        reprob=cfg.aug.reprob, remode=cfg.aug.remode, recount=cfg.aug.recount)
