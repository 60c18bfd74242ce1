"""Shared small ops: stochastic depth, dropout, attention-bias index tables,
and the 16-byte alignment the CUDA kernels' vector accesses need.

The random draws take an explicit `torch.Generator` (the counterpart of the
JAX package's rng keys); they cannot give JAX's bits, only its
distribution. Under a data-parallel group (`core.mesh`) a draw is made for
the global batch, whose rows are the data ranks' rows in data-rank order, and
each rank keeps its own rows, as the JAX package's one key over the sharded
global shape gives: W ranks then draw what one card draws on the
concatenated batch, and model peers (`core.mesh`), which hold the same
rows, draw the same numbers."""
from __future__ import annotations

import itertools

import numpy as np
import torch

from cream_tpu_torch.core.mesh import data_group, global_rows


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it when its data does not start on a 16-byte boundary
    (a view with an offset): kernels that move 16 bytes per access need it."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def uniform_rows(shape, generator: torch.Generator) -> torch.Tensor:
    """U[0, 1) draws of `shape` on the generator's device for a tensor whose
    dim 0 holds this rank's rows of the global batch: without a group the
    draws themselves, under one this rank's rows of the draws for the
    global shape."""
    if data_group() is None:
        return torch.rand(shape, generator=generator, device=generator.device)
    total, lo, hi = global_rows(shape[0])
    return torch.rand((total, *shape[1:]), generator=generator,
                      device=generator.device)[lo:hi]


def drop_path(x: torch.Tensor, rate: float, deterministic: bool,
              generator: torch.Generator | None = None) -> torch.Tensor:
    """Stochastic depth on the residual branch (per-sample): keep with prob
    1-rate and rescale by 1/(1-rate). The identity in eval."""
    if deterministic or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("drop_path needs a generator in training mode")
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    mask = uniform_rows(shape, generator) < keep
    return x * mask.to(x.device, x.dtype) / keep


def dropout(x: torch.Tensor, rate: float, deterministic: bool,
            generator: torch.Generator | None = None) -> torch.Tensor:
    """Element-wise dropout as flax `nn.Dropout` does it: keep with prob
    1-rate, kept values x/(1-rate), dropped ones 0. The identity in eval.
    Unlike `F.dropout` it draws from the given generator."""
    if deterministic or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout needs a generator in training mode")
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    mask = uniform_rows(x.shape, generator) < keep
    return torch.where(mask.to(x.device), x / keep, torch.zeros_like(x))


def attention_bias_indices(resolution: tuple[int, int]) -> tuple[np.ndarray, int]:
    """LeViT-style per-offset attention bias index table.

    For every ordered pair of positions (p1, p2) on an H×W grid, bucket by the
    absolute offset (|dy|, |dx|); buckets are numbered in first-seen order while
    scanning pairs row-major. Returns (idxs[N, N] int32, num_offsets), the table
    released TinyViT/EfficientViT checkpoints' `attention_biases` rows follow.
    """
    H, W = resolution
    points = list(itertools.product(range(H), range(W)))
    offsets: dict[tuple[int, int], int] = {}
    idxs = []
    for p1 in points:
        for p2 in points:
            off = (abs(p1[0] - p2[0]), abs(p1[1] - p2[1]))
            if off not in offsets:
                offsets[off] = len(offsets)
            idxs.append(offsets[off])
    N = len(points)
    return np.asarray(idxs, dtype=np.int32).reshape(N, N), len(offsets)
