"""Deterministic RandAugment / AutoAugment / AugMix / RandomErasing /
ColorJitter on uint8 RGB arrays.

Counterpart of `cream_tpu/data/auto_augment.py` (the timm stack that
TinyViT vendors and seeds, TinyViT/data/augmentation/{auto_augment,
random_erasing}.py + aug_random.py:1-61). Every op takes an explicit
np.random.Generator and makes the JAX module's draws in its order, so an
image and a seed give the JAX module's pixels exactly; the Pillow calls
are `pil_ops`' numpy versions of them, bit for bit, and need no Pillow.

Magnitude semantics match timm: level in [0, 10] (`_LEVEL_DENOM`), config
strings like 'rand-m9-mstd0.5-inc1', increasing-severity variants, 50%%
random negation for signed ops, RandomErasing with the reference's
224-referenced box geometry (resolution-independent erase layout).
"""
from __future__ import annotations

import math
import re
from typing import Callable, Sequence

import numpy as np

from cream_tpu_torch.data import pil_ops

_LEVEL_DENOM = 10.0
_FILL = (128, 128, 128)
_HPARAMS_DEFAULT = dict(translate_const=250, img_mean=_FILL)


# ----------------------------------------------------------------- pixel ops

def shear_x(img, factor, fill=_FILL):
    return pil_ops.affine_bilinear(img, (1, factor, 0, 0, 1, 0), fill)


def shear_y(img, factor, fill=_FILL):
    return pil_ops.affine_bilinear(img, (1, 0, 0, factor, 1, 0), fill)


def translate_x_rel(img, pct, fill=_FILL):
    return pil_ops.affine_bilinear(img, (1, 0, pct * img.shape[1], 0, 1, 0), fill)


def translate_y_rel(img, pct, fill=_FILL):
    return pil_ops.affine_bilinear(img, (1, 0, 0, 0, 1, pct * img.shape[0]), fill)


def translate_x_abs(img, pixels, fill=_FILL):
    return pil_ops.affine_bilinear(img, (1, 0, pixels, 0, 1, 0), fill)


def translate_y_abs(img, pixels, fill=_FILL):
    return pil_ops.affine_bilinear(img, (1, 0, 0, 0, 1, pixels), fill)


def rotate(img, degrees, fill=_FILL):
    return pil_ops.rotate_bilinear(img, degrees, fill)


def auto_contrast(img, *a, **k):
    return pil_ops.autocontrast(img)


def invert(img, *a, **k):
    return pil_ops.invert(img)


def equalize(img, *a, **k):
    return pil_ops.equalize(img)


def solarize(img, thresh, **k):
    return pil_ops.solarize(img, thresh)


def solarize_add(img, add, thresh=128, **k):
    return pil_ops.point(img, [min(255, i + add) if i < thresh else i for i in range(256)])


def posterize(img, bits_to_keep, **k):
    if bits_to_keep >= 8:
        return img
    return pil_ops.posterize(img, bits_to_keep)


def contrast(img, factor, **k):
    return pil_ops.enhance_contrast(img, factor)


def color(img, factor, **k):
    return pil_ops.enhance_color(img, factor)


def brightness(img, factor, **k):
    return pil_ops.enhance_brightness(img, factor)


def sharpness(img, factor, **k):
    return pil_ops.enhance_sharpness(img, factor)


# ------------------------------------------------------------ level -> args

def _negate(rng, v):
    return -v if rng.random() > 0.5 else v


def _rotate_arg(level, rng, hp):
    return (_negate(rng, level / _LEVEL_DENOM * 30.0),)


def _enhance_arg(level, rng, hp):
    return (level / _LEVEL_DENOM * 1.8 + 0.1,)


def _enhance_inc_arg(level, rng, hp):
    return (max(0.1, 1.0 + _negate(rng, level / _LEVEL_DENOM * 0.9)),)


def _shear_arg(level, rng, hp):
    return (_negate(rng, level / _LEVEL_DENOM * 0.3),)


def _translate_abs_arg(level, rng, hp):
    return (_negate(rng, level / _LEVEL_DENOM * hp["translate_const"]),)


def _translate_rel_arg(level, rng, hp):
    return (_negate(rng, level / _LEVEL_DENOM * hp.get("translate_pct", 0.45)),)


def _posterize_arg(level, rng, hp):
    return (int(level / _LEVEL_DENOM * 4),)


def _posterize_inc_arg(level, rng, hp):
    return (4 - int(level / _LEVEL_DENOM * 4),)


def _posterize_orig_arg(level, rng, hp):
    return (int(level / _LEVEL_DENOM * 4) + 4,)


def _solarize_arg(level, rng, hp):
    return (int(level / _LEVEL_DENOM * 256),)


def _solarize_inc_arg(level, rng, hp):
    return (256 - int(level / _LEVEL_DENOM * 256),)


def _solarize_add_arg(level, rng, hp):
    return (int(level / _LEVEL_DENOM * 110),)


_OPS: dict[str, tuple[Callable, Callable | None]] = {
    "AutoContrast": (auto_contrast, None),
    "Equalize": (equalize, None),
    "Invert": (invert, None),
    "Rotate": (rotate, _rotate_arg),
    "Posterize": (posterize, _posterize_arg),
    "PosterizeIncreasing": (posterize, _posterize_inc_arg),
    "PosterizeOriginal": (posterize, _posterize_orig_arg),
    "Solarize": (solarize, _solarize_arg),
    "SolarizeIncreasing": (solarize, _solarize_inc_arg),
    "SolarizeAdd": (solarize_add, _solarize_add_arg),
    "Color": (color, _enhance_arg),
    "ColorIncreasing": (color, _enhance_inc_arg),
    "Contrast": (contrast, _enhance_arg),
    "ContrastIncreasing": (contrast, _enhance_inc_arg),
    "Brightness": (brightness, _enhance_arg),
    "BrightnessIncreasing": (brightness, _enhance_inc_arg),
    "Sharpness": (sharpness, _enhance_arg),
    "SharpnessIncreasing": (sharpness, _enhance_inc_arg),
    "ShearX": (shear_x, _shear_arg),
    "ShearY": (shear_y, _shear_arg),
    "TranslateX": (translate_x_abs, _translate_abs_arg),
    "TranslateY": (translate_y_abs, _translate_abs_arg),
    "TranslateXRel": (translate_x_rel, _translate_rel_arg),
    "TranslateYRel": (translate_y_rel, _translate_rel_arg),
}


class AugmentOp:
    """One named op with probability + (possibly randomized) magnitude."""

    def __init__(self, name: str, prob: float = 0.5, magnitude: float = 10,
                 hparams: dict | None = None):
        self.name = name
        self.aug_fn, self.level_fn = _OPS[name]
        self.prob = prob
        self.magnitude = magnitude
        self.hparams = dict(_HPARAMS_DEFAULT, **(hparams or {}))
        self.magnitude_std = self.hparams.get("magnitude_std", 0)
        self.magnitude_max = self.hparams.get("magnitude_max", None)
        self.fill = tuple(self.hparams.get("img_mean", _FILL))

    def __call__(self, img: np.ndarray, rng: np.random.Generator):
        if self.prob < 1.0 and rng.random() > self.prob:
            return img
        magnitude = self.magnitude
        if self.magnitude_std:
            if self.magnitude_std == float("inf"):
                magnitude = rng.uniform(0, magnitude)
            else:
                magnitude = rng.normal(magnitude, self.magnitude_std)
        upper = self.magnitude_max or _LEVEL_DENOM
        magnitude = max(0.0, min(magnitude, upper))
        args = (self.level_fn(magnitude, rng, self.hparams)
                if self.level_fn else ())
        if self.aug_fn in (shear_x, shear_y, translate_x_rel, translate_y_rel,
                           translate_x_abs, translate_y_abs, rotate):
            return self.aug_fn(img, *args, fill=self.fill)
        return self.aug_fn(img, *args)


_RAND_TRANSFORMS = [
    "AutoContrast", "Equalize", "Invert", "Rotate", "Posterize", "Solarize",
    "SolarizeAdd", "Color", "Contrast", "Brightness", "Sharpness", "ShearX",
    "ShearY", "TranslateXRel", "TranslateYRel",
]

_RAND_INCREASING_TRANSFORMS = [
    "AutoContrast", "Equalize", "Invert", "Rotate", "PosterizeIncreasing",
    "SolarizeIncreasing", "SolarizeAdd", "ColorIncreasing",
    "ContrastIncreasing", "BrightnessIncreasing", "SharpnessIncreasing",
    "ShearX", "ShearY", "TranslateXRel", "TranslateYRel",
]


class RandAugment:
    def __init__(self, ops: Sequence[AugmentOp], num_layers: int = 2):
        self.ops = list(ops)
        self.num_layers = num_layers

    def __call__(self, img: np.ndarray, rng: np.random.Generator):
        picks = rng.choice(len(self.ops), self.num_layers, replace=True)
        for i in picks:
            img = self.ops[int(i)](img, rng)
        return img


def rand_augment_transform(config_str: str,
                           hparams: dict | None = None) -> RandAugment:
    """Parse 'rand-m9-mstd0.5-inc1'-style strings (timm grammar: m/n/mstd/
    mmax/inc sections)."""
    hparams = dict(hparams or {})
    magnitude, num_layers = _LEVEL_DENOM, 2
    transforms = _RAND_TRANSFORMS
    config = config_str.split("-")
    assert config[0] == "rand", config_str
    for c in config[1:]:
        cs = re.split(r"(\d.*)", c)
        if len(cs) < 2:
            continue
        key, val = cs[:2]
        if key == "mstd":
            mstd = float(val)
            hparams.setdefault("magnitude_std",
                               float("inf") if mstd > 100 else mstd)
        elif key == "mmax":
            hparams.setdefault("magnitude_max", int(val))
        elif key == "inc":
            if bool(int(val)):
                transforms = _RAND_INCREASING_TRANSFORMS
        elif key == "m":
            magnitude = int(val)
        elif key == "n":
            num_layers = int(val)
        else:
            raise ValueError(f"unknown RandAugment section {key!r}")
    ops = [AugmentOp(n, prob=0.5, magnitude=magnitude, hparams=hparams)
           for n in transforms]
    return RandAugment(ops, num_layers)


# ---------------------------------------------------------------- AutoAugment

# (name, prob, magnitude) sub-policy pairs — AutoAugment ImageNet policies
# ('v0' = TF EfficientNet, 'original' = the AutoAugment paper), as listed in
# the vendored stack (auto_augment.py policy tables).
_POLICY_V0 = [
    [("Equalize", 0.8, 1), ("ShearY", 0.8, 4)],
    [("Color", 0.4, 9), ("Equalize", 0.6, 3)],
    [("Color", 0.4, 1), ("Rotate", 0.6, 8)],
    [("Solarize", 0.8, 3), ("Equalize", 0.4, 7)],
    [("Solarize", 0.4, 2), ("Solarize", 0.6, 2)],
    [("Color", 0.2, 0), ("Equalize", 0.8, 8)],
    [("Equalize", 0.4, 8), ("SolarizeAdd", 0.8, 3)],
    [("ShearX", 0.2, 9), ("Rotate", 0.6, 8)],
    [("Color", 0.6, 1), ("Equalize", 1.0, 2)],
    [("Invert", 0.4, 9), ("Rotate", 0.6, 0)],
    [("Equalize", 1.0, 9), ("ShearY", 0.6, 3)],
    [("Color", 0.4, 7), ("Equalize", 0.6, 0)],
    [("Posterize", 0.4, 6), ("AutoContrast", 0.4, 7)],
    [("Solarize", 0.6, 8), ("Color", 0.6, 9)],
    [("Solarize", 0.2, 4), ("Rotate", 0.8, 9)],
    [("Rotate", 1.0, 7), ("TranslateYRel", 0.8, 9)],
    [("ShearX", 0.0, 0), ("Solarize", 0.8, 4)],
    [("ShearY", 0.8, 0), ("Color", 0.6, 4)],
    [("Color", 1.0, 0), ("Rotate", 0.6, 2)],
    [("Equalize", 0.8, 4), ("Equalize", 0.0, 8)],
    [("Equalize", 1.0, 4), ("AutoContrast", 0.6, 2)],
    [("ShearY", 0.4, 7), ("SolarizeAdd", 0.6, 7)],
    [("Posterize", 0.8, 2), ("Solarize", 0.6, 10)],
    [("Solarize", 0.6, 8), ("Equalize", 0.6, 1)],
    [("Color", 0.8, 6), ("Rotate", 0.4, 5)],
]

_POLICY_ORIGINAL = [
    [("PosterizeOriginal", 0.4, 8), ("Rotate", 0.6, 9)],
    [("Solarize", 0.6, 5), ("AutoContrast", 0.6, 5)],
    [("Equalize", 0.8, 8), ("Equalize", 0.6, 3)],
    [("PosterizeOriginal", 0.6, 7), ("PosterizeOriginal", 0.6, 6)],
    [("Equalize", 0.4, 7), ("Solarize", 0.2, 4)],
    [("Equalize", 0.4, 4), ("Rotate", 0.8, 8)],
    [("Solarize", 0.6, 3), ("Equalize", 0.6, 7)],
    [("PosterizeOriginal", 0.8, 5), ("Equalize", 1.0, 2)],
    [("Rotate", 0.2, 3), ("Solarize", 0.6, 8)],
    [("Equalize", 0.6, 8), ("PosterizeOriginal", 0.4, 6)],
    [("Rotate", 0.8, 8), ("Color", 0.4, 0)],
    [("Rotate", 0.4, 9), ("Equalize", 0.6, 2)],
    [("Equalize", 0.0, 7), ("Equalize", 0.8, 8)],
    [("Invert", 0.6, 4), ("Equalize", 1.0, 8)],
    [("Color", 0.6, 4), ("Contrast", 1.0, 8)],
    [("Rotate", 0.8, 8), ("Color", 1.0, 2)],
    [("Color", 0.8, 8), ("Solarize", 0.8, 7)],
    [("Sharpness", 0.4, 7), ("Invert", 0.6, 8)],
    [("ShearX", 0.6, 5), ("Equalize", 1.0, 9)],
    [("Color", 0.4, 0), ("Equalize", 0.6, 3)],
    [("Equalize", 0.4, 7), ("Solarize", 0.2, 4)],
    [("Solarize", 0.6, 5), ("AutoContrast", 0.6, 5)],
    [("Invert", 0.6, 4), ("Equalize", 1.0, 8)],
    [("Color", 0.6, 4), ("Contrast", 1.0, 8)],
    [("Equalize", 0.8, 8), ("Equalize", 0.6, 3)],
]


class AutoAugment:
    def __init__(self, policy: Sequence, hparams: dict | None = None):
        self.policy = [[AugmentOp(n, p, m, hparams) for n, p, m in sub]
                       for sub in policy]

    def __call__(self, img: np.ndarray, rng: np.random.Generator):
        sub = self.policy[int(rng.integers(len(self.policy)))]
        for op in sub:
            img = op(img, rng)
        return img


def auto_augment_transform(config_str: str,
                           hparams: dict | None = None) -> AutoAugment:
    """'original' | 'v0' (timm grammar 'original-mstd0.5' also accepted)."""
    config = config_str.split("-")
    name = config[0]
    hparams = dict(hparams or {})
    for c in config[1:]:
        cs = re.split(r"(\d.*)", c)
        if len(cs) >= 2 and cs[0] == "mstd":
            hparams.setdefault("magnitude_std", float(cs[1]))
    if name in ("original", "originalr"):
        return AutoAugment(_POLICY_ORIGINAL, hparams)
    if name in ("v0", "v0r"):
        return AutoAugment(_POLICY_V0, hparams)
    raise ValueError(f"unknown AutoAugment policy {name!r}")


# -------------------------------------------------------------------- AugMix

_AUGMIX_TRANSFORMS = [
    "AutoContrast", "ColorIncreasing", "ContrastIncreasing",
    "BrightnessIncreasing", "SharpnessIncreasing", "Equalize", "Rotate",
    "PosterizeIncreasing", "SolarizeIncreasing", "ShearX", "ShearY",
    "TranslateXRel", "TranslateYRel",
]


class AugMix:
    """AugMix (arXiv:1912.02781) with the vendored stack's semantics
    (TinyViT/data/augmentation/auto_augment.py:738-800 AugMixAugment,
    '_apply_basic' literal path): `width` parallel chains of 1..3 (or fixed
    `depth`) ops, Dirichlet(alpha)-weighted pixel mix, then a Beta(alpha,
    alpha) blend with the original. All randomness flows through the
    per-sample Generator, so saved-teacher-logit replays reproduce pixels
    exactly (the seeded-aug contract)."""

    def __init__(self, ops: Sequence[AugmentOp], alpha: float = 1.0,
                 width: int = 3, depth: int = -1):
        self.ops = list(ops)
        self.alpha = alpha
        self.width = width
        self.depth = depth

    def __call__(self, img: np.ndarray, rng: np.random.Generator):
        mixing_weights = np.float32(rng.dirichlet([self.alpha] * self.width))
        m = np.float32(rng.beta(self.alpha, self.alpha))
        # (H, W, C), row-major (the reference's (W, H) works only after a
        # square crop)
        mixed = np.zeros(img.shape, dtype=np.float32)
        for mw in mixing_weights:
            depth = self.depth if self.depth > 0 else int(rng.integers(1, 4))
            picks = rng.choice(len(self.ops), depth, replace=True)
            img_aug = img
            for i in picks:
                img_aug = self.ops[int(i)](img_aug, rng)
            mixed += mw * np.asarray(img_aug, dtype=np.float32)
        np.clip(mixed, 0, 255.0, out=mixed)
        return pil_ops.blend(img, mixed.astype(np.uint8), m)


def augment_and_mix_transform(config_str: str,
                              hparams: dict | None = None) -> AugMix:
    """Parse 'augmix-m5-w4-d2'-style strings (timm grammar: m/w/d/a/mstd)."""
    hparams = dict(hparams or {})
    magnitude, width, depth, alpha = 3, 3, -1, 1.0
    config = config_str.split("-")
    assert config[0] == "augmix", config_str
    for c in config[1:]:
        cs = re.split(r"(\d.*)", c)
        if len(cs) < 2:
            continue
        key, val = cs[:2]
        if key == "mstd":
            hparams.setdefault("magnitude_std", float(val))
        elif key == "m":
            magnitude = int(val)
        elif key == "w":
            width = int(val)
        elif key == "d":
            depth = int(val)
        elif key == "a":
            alpha = float(val)
        else:
            raise ValueError(f"unknown AugMix section {key!r}")
    hparams.setdefault("magnitude_std", float("inf"))
    ops = [AugmentOp(n, prob=1.0, magnitude=magnitude, hparams=hparams)
           for n in _AUGMIX_TRANSFORMS]
    return AugMix(ops, alpha=alpha, width=width, depth=depth)


def create_augmenter(config_str: str, hparams: dict | None = None):
    """Dispatch on the config string prefix like timm's transforms factory."""
    if not config_str:
        return None
    if config_str.startswith("rand"):
        return rand_augment_transform(config_str, hparams)
    if config_str.startswith("augmix"):
        return augment_and_mix_transform(config_str, hparams)
    return auto_augment_transform(config_str, hparams)


# ------------------------------------------------------------ random erasing

class RandomErasing:
    """timm RandomErasing on a normalized float HWC array; box geometry is
    drawn on a 224x224 reference grid then rescaled (the reference's
    resolution-independence patch, random_erasing.py REF_H/REF_W)."""

    REF = 224

    def __init__(self, probability: float = 0.5, min_area: float = 0.02,
                 max_area: float = 1 / 3, min_aspect: float = 0.3,
                 mode: str = "pixel", min_count: int = 1,
                 max_count: int | None = None):
        self.probability = probability
        self.min_area, self.max_area = min_area, max_area
        self.log_aspect = (math.log(min_aspect), math.log(1 / min_aspect))
        self.min_count = min_count
        self.max_count = max_count or min_count
        assert mode in ("const", "rand", "pixel")
        self.mode = mode

    def _fill(self, rng, h, w, c):
        if self.mode == "pixel":
            return rng.normal(size=(h, w, c)).astype(np.float32)
        if self.mode == "rand":
            return np.broadcast_to(
                rng.normal(size=(1, 1, c)).astype(np.float32), (h, w, c))
        return np.zeros((h, w, c), np.float32)

    def __call__(self, arr: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        if rng.random() > self.probability:
            return arr
        H, W, C = arr.shape
        count = (self.min_count if self.min_count == self.max_count
                 else int(rng.integers(self.min_count, self.max_count + 1)))
        ref = self.REF
        for _ in range(count):
            for _attempt in range(10):
                target = rng.uniform(self.min_area, self.max_area) * \
                    ref * ref / count
                ar = math.exp(rng.uniform(*self.log_aspect))
                h = int(round(math.sqrt(target * ar)))
                w = int(round(math.sqrt(target / ar)))
                if w < ref and h < ref:
                    top = int(rng.integers(0, ref - h + 1))
                    left = int(rng.integers(0, ref - w + 1))
                    top = min(int(round(top * H / ref)), H - 1)
                    left = min(int(round(left * W / ref)), W - 1)
                    h2 = min(int(round(h * H / ref)), H - top)
                    w2 = min(int(round(w * W / ref)), W - left)
                    arr[top:top + h2, left:left + w2] = \
                        self._fill(rng, h2, w2, C)
                    break
        return arr


# -------------------------------------------------------------- color jitter

def color_jitter(img: np.ndarray, rng: np.random.Generator,
                 strength: float = 0.4) -> np.ndarray:
    """torchvision ColorJitter(brightness=contrast=saturation=strength):
    factors uniform in [max(0, 1-s), 1+s], applied in a random order."""
    if strength <= 0:
        return img
    enhancers = [pil_ops.enhance_brightness, pil_ops.enhance_contrast,
                 pil_ops.enhance_color]
    order = rng.permutation(3)
    lo = max(0.0, 1.0 - strength)
    factors = rng.uniform(lo, 1.0 + strength, size=3)
    for i in order:
        img = enhancers[int(i)](img, float(factors[int(i)]))
    return img
