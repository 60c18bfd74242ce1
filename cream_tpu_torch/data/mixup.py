"""Mixup / CutMix with explicit generators.

Counterpart of `cream_tpu/data/mixup.py` (timm's batch-mode Mixup: one
lambda per batch, mixing with the flipped batch; and TinyViT's seeded pair
mode). The scalar draws (which mode, lambda, the box) come from a CPU
`torch.Generator` on the host, as timm draws them with numpy; the pixel and
target mixing runs wherever the images are. The draws cannot give the JAX
package's numbers; given the same lambda and box, the mixing is the same.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def _uniform(gen: torch.Generator) -> float:
    return float(torch.rand((), generator=gen))


def _gamma(gen: torch.Generator, alpha: float) -> float:
    """Gamma(alpha, 1) by Marsaglia-Tsang (alpha < 1 via the U^(1/alpha)
    boost)."""
    if alpha < 1.0:
        return _gamma(gen, alpha + 1.0) * _uniform(gen) ** (1.0 / alpha)
    d = alpha - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    while True:
        x = float(torch.randn((), generator=gen))
        v = (1.0 + c * x) ** 3
        if v <= 0.0:
            continue
        u = _uniform(gen)
        if u > 0.0 and math.log(u) < 0.5 * x * x + d - d * v + d * math.log(v):
            return d * v


def beta(gen: torch.Generator, alpha: float) -> float:
    """A Beta(alpha, alpha) draw."""
    a, b = _gamma(gen, alpha), _gamma(gen, alpha)
    return a / (a + b)


def cutmix_box(gen: torch.Generator, H: int, W: int, lam: float):
    """A box of area ratio ~(1-lam) around a uniform centre, clipped to the
    map: returns ((y0, y1, x0, x1), lam corrected to the box's real area)."""
    cut = math.sqrt(1.0 - lam)
    ch, cw = int(cut * H), int(cut * W)
    ry = int(torch.randint(0, H, (), generator=gen))
    rx = int(torch.randint(0, W, (), generator=gen))
    y0, y1 = min(max(ry - ch // 2, 0), H), min(max(ry + ch // 2, 0), H)
    x0, x1 = min(max(rx - cw // 2, 0), W), min(max(rx + cw // 2, 0), W)
    return (y0, y1, x0, x1), 1.0 - ((y1 - y0) * (x1 - x0)) / (H * W)


def smooth_one_hot(labels: torch.Tensor, num_classes: int,
                   smoothing: float) -> torch.Tensor:
    """one_hot * (on - off) + off, with off = smoothing/C, on = 1 - smoothing + off."""
    off = smoothing / num_classes
    on = 1.0 - smoothing + off
    return F.one_hot(labels.long(), num_classes).float() * (on - off) + off


def _targets(labels, num_classes, smoothing):
    return labels if labels.ndim == 2 else smooth_one_hot(labels, num_classes, smoothing)


def mix_batch(images: torch.Tensor, targets: torch.Tensor, lam: float,
              box: tuple[int, int, int, int] | None = None):
    """Mix each example with its partner in the flipped batch: images
    blended by lam (mixup), or the box pasted from the partner (cutmix,
    lam being the box-corrected one); targets blended by lam."""
    flipped = images.flip(0)
    if box is None:
        out = images * lam + flipped * (1.0 - lam)
    else:
        y0, y1, x0, x1 = box
        out = images.clone()
        out[:, y0:y1, x0:x1] = flipped[:, y0:y1, x0:x1]
    return out, targets * lam + targets.flip(0) * (1.0 - lam)


def _draw_mode(gen, mixup_alpha, cutmix_alpha, switch_prob):
    """(use_cutmix, lam_mixup, lam_cutmix): with one mode off, always the
    other (timm)."""
    if cutmix_alpha <= 0:
        use_cutmix = False
    elif mixup_alpha <= 0:
        use_cutmix = True
    else:
        use_cutmix = _uniform(gen) < switch_prob
    lam_mix = beta(gen, mixup_alpha) if mixup_alpha > 0 else 1.0
    lam_cut = beta(gen, cutmix_alpha) if cutmix_alpha > 0 else 1.0
    return use_cutmix, lam_mix, lam_cut


def mixup_cutmix(gen: torch.Generator, images: torch.Tensor,
                 labels: torch.Tensor, num_classes: int,
                 mixup_alpha: float = 0.8, cutmix_alpha: float = 1.0,
                 switch_prob: float = 0.5, smoothing: float = 0.1):
    """Returns (mixed images NHWC, soft targets (B, num_classes) fp32).

    Batch mode: one lambda, partner = flipped batch. Soft labels (B, C) are
    mixed as they are (the distillation pipeline's case). With both alphas
    0 the images are unchanged and the targets are the smoothed one-hots."""
    _, H, W, _ = images.shape
    y = _targets(labels, num_classes, smoothing).to(images.device)
    use_cutmix, lam_mix, lam_cut = _draw_mode(gen, mixup_alpha, cutmix_alpha,
                                              switch_prob)
    if use_cutmix:
        box, lam = cutmix_box(gen, H, W, lam_cut)
        return mix_batch(images, y, lam, box)
    return mix_batch(images, y, lam_mix)


def seeded_pair_mixup(seeds, images: torch.Tensor, labels: torch.Tensor,
                      num_classes: int, mixup_alpha: float = 0.8,
                      cutmix_alpha: float = 1.0, switch_prob: float = 0.5,
                      smoothing: float = 0.1):
    """Seed-deterministic pair mixup (TinyViT's `pair2` mode): each pair
    (2i, 2i+1) is mixed with its partner using (mode, lam, box) drawn from a
    generator seeded with seeds[2i] ^ seeds[2i+1], so replaying the same
    per-sample aug seeds reproduces the same mix anywhere. lam is fp32, so
    bf16 images are mixed, and returned, in fp32, as the JAX function's
    fp32 lam promotes them: the caller casts to its compute dtype after the
    mix, the rounding point of the JAX trainer and save_logits."""
    B, H, W, _ = images.shape
    if B % 2:
        raise ValueError("pair mixup needs an even batch")
    seeds = np.asarray(seeds).astype(np.int64)
    pair_seed = (seeds[0::2] ^ seeds[1::2]) & 0xFFFFFFFF
    flags, lams, boxes = [], [], []
    for s in pair_seed:
        gen = torch.Generator().manual_seed(int(s))
        use_cutmix, lam_mix, lam_cut = _draw_mode(gen, mixup_alpha,
                                                  cutmix_alpha, switch_prob)
        box, lam_adj = cutmix_box(gen, H, W, lam_cut)
        flags.append(use_cutmix)
        lams.append(lam_adj if use_cutmix else lam_mix)
        boxes.append(box)
    dev = images.device
    lam = torch.tensor(lams, dtype=torch.float32, device=dev)
    bx = torch.tensor(boxes, device=dev)                     # (B/2, 4)
    yy = torch.arange(H, device=dev)[None, :, None]
    xx = torch.arange(W, device=dev)[None, None, :]
    mask = ((yy >= bx[:, 0, None, None]) & (yy < bx[:, 1, None, None])
            & (xx >= bx[:, 2, None, None]) & (xx < bx[:, 3, None, None]))
    cutmix = torch.tensor(flags, device=dev)
    pairs = images.reshape(B // 2, 2, H, W, -1)
    partner = pairs.flip(1)
    lam_b = lam[:, None, None, None, None]
    mixed = pairs * lam_b + partner * (1.0 - lam_b)
    cut = torch.where(mask[:, None, :, :, None], partner, pairs)
    out = torch.where(cutmix[:, None, None, None, None], cut, mixed).reshape(images.shape)
    y = _targets(labels, num_classes, smoothing).to(dev).reshape(B // 2, 2, -1)
    lam_t = lam[:, None, None]
    targets = (y * lam_t + y.flip(1) * (1.0 - lam_t)).reshape(B, -1)
    return out, targets
