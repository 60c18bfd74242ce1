"""Bilinear spatial resize as two contractions with interpolation matrices.

Counterpart of `cream_tpu/ops/resize.py`: torch's bilinear semantics for
both conventions the CyDAS reference mixes in one model (align_corners=True
in its attention blocks, False in the decoder). The (out, in) matrices are
made on the host once per (out, in, align_corners) and kept on the device per
dtype; the resize contracts the rows, then the columns, with the matrices
cast to x's dtype, so under bf16 it rounds where the JAX package's does.
Both contractions are plain batched GEMMs, whose backward is two more
(deterministic, no atomics).
"""
from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def bilinear_matrix(out_size: int, in_size: int, align_corners: bool) -> np.ndarray:
    """(out, in) row-stochastic float32 interpolation matrix, torch-exact:
    align_corners=False takes half-pixel centres with the source coordinate
    clamped at 0; align_corners=True maps the end points to the end points."""
    m = np.zeros((out_size, in_size), np.float32)
    for i in range(out_size):
        if align_corners:
            src = 0.0 if out_size == 1 else i * (in_size - 1) / (out_size - 1)
        else:
            src = max((i + 0.5) * in_size / out_size - 0.5, 0.0)
        src = min(src, in_size - 1.0)
        lo = int(np.floor(src))
        hi = min(lo + 1, in_size - 1)
        f = src - lo
        m[i, lo] += 1.0 - f
        m[i, hi] += f
    return m


_DEVICE_MATRICES: dict[tuple, torch.Tensor] = {}


def _matrix(out_size: int, in_size: int, align_corners: bool, like: torch.Tensor
            ) -> torch.Tensor:
    key = (out_size, in_size, align_corners, like.device, like.dtype)
    m = _DEVICE_MATRICES.get(key)
    if m is None:
        # made outside inference mode: autograd saves it for the backward
        with torch.inference_mode(False):
            m = torch.from_numpy(bilinear_matrix(out_size, in_size, align_corners)).to(
                like.device, like.dtype)
        _DEVICE_MATRICES[key] = m
    return m


def bilinear_resize(x: torch.Tensor, out_hw: tuple[int, int],
                    align_corners: bool = False) -> torch.Tensor:
    """Resize the NHWC map x to `out_hw`; x itself where the size is kept."""
    oh, ow = int(out_hw[0]), int(out_hw[1])
    n, h, w, c = x.shape
    if (oh, ow) == (h, w):
        return x
    mh = _matrix(oh, h, align_corners, x)
    mw = _matrix(ow, w, align_corners, x)
    y = torch.matmul(mh, x.reshape(n, h, w * c))                # (n, oh, w*c)
    y = torch.matmul(mw, y.reshape(n * oh, w, c))               # (n*oh, ow, c)
    return y.reshape(n, oh, ow, c)
