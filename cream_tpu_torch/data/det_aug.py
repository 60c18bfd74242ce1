"""Per-sample augmentation seeds.

Counterpart of `sample_seed` in `cream_tpu/data/det_aug.py`: every sample's
augmentation is a pure function of an int32 seed of (base seed, epoch,
sample index), so teacher logits saved for epoch e, sample i stay valid
when the student replays seed(e, i) (TinyViT's fast distillation). The
JAX module's PIL transforms (random resized crop, flip, RandAugment, random
erasing) are not ported yet; the port's train loader only normalizes.
"""
from __future__ import annotations


def sample_seed(base_seed: int, epoch: int, index: int) -> int:
    """Stable per-(epoch, sample) seed (int32, SplitMix-style)."""
    x = (base_seed * 0x9E3779B1 + epoch * 0x85EBCA77 + index * 0xC2B2AE3D)
    x &= 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x7FEB352D) & 0xFFFFFFFF
    x ^= x >> 15
    return int(x & 0x7FFFFFFF)
