"""iRPE (image relative position encoding) bucketing, on the host in numpy.

Counterpart of `cream_tpu/ops/rpe.py` (the bucketing of
iRPE/DeiT-with-iRPE/irpe.py): the piecewise index function, the method
kernels euclidean / quant / product / cross, the bucket-id tables with the
cls-token skip, and the config constructors.

A bucket table depends only on (method, H, W, skip, alpha, beta, gamma), so
it is made once on the host (lru-cached) and the modules of `nn/rpe.py` keep
it on the device as a buffer: nothing is computed per call.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np


class METHOD:
    EUCLIDEAN = 0
    QUANT = 1
    PRODUCT = 3
    CROSS = 4
    CROSS_ROWS = 41
    CROSS_COLS = 42


_METHOD_NAMES = {"euc": METHOD.EUCLIDEAN, "quant": METHOD.QUANT,
                 "cross": METHOD.CROSS, "product": METHOD.PRODUCT}


def piecewise_index(rel: np.ndarray, alpha: float, beta: float, gamma: float
                    ) -> np.ndarray:
    """Piecewise bucketing: the identity within |x| <= alpha, log-spaced
    beyond, saturating at beta (Eq. 18 of the iRPE paper; irpe.py:18-52).
    Integer inputs stay exact in the linear region; rounding is
    round-half-to-even, as numpy's and torch's."""
    rel = np.asarray(rel)
    abs_rel = np.abs(rel)
    if np.issubdtype(rel.dtype, np.floating):
        idx = np.round(rel)
    else:
        idx = rel.astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        log_part = np.sign(rel) * np.clip(
            np.round(alpha + np.log(np.maximum(abs_rel, 1e-12) / alpha)
                     / math.log(gamma / alpha) * (beta - alpha)),
            a_min=None, a_max=beta)
    out = np.where(abs_rel <= alpha, idx, log_part)
    return out.astype(np.int64)


def _diff_grid(height: int, width: int) -> np.ndarray:
    """(L, L, 2) pairwise 2D offsets on an H x W grid, row-major."""
    rows, cols = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    pos = np.stack([rows.ravel(), cols.ravel()], axis=1)   # (L, 2)
    return pos[:, None, :] - pos[None, :, :]


def num_buckets(method: int, beta: float, skip: int = 0) -> int:
    """Buckets of a table: (2·⌊beta⌋ + 1)² for product, 2·⌊beta⌋ + 1
    otherwise, one more for the skipped (cls) tokens."""
    beta_int = int(beta)
    n = (2 * beta_int + 1) ** 2 if method == METHOD.PRODUCT else 2 * beta_int + 1
    return n + (1 if skip > 0 else 0)


@functools.lru_cache(maxsize=None)
def bucket_ids_2d(method: int, height: int, width: int, skip: int,
                  alpha: float, beta: float, gamma: float
                  ) -> tuple[np.ndarray, int]:
    """The (skip + L, skip + L) int32 bucket-id table and its bucket count
    (the skip bucket included). The first `skip` rows and columns hold the
    extra bucket. The cached array is shared: do not write to it."""
    diff = _diff_grid(height, width)
    beta_int = int(beta)
    kw = dict(alpha=alpha, beta=beta, gamma=gamma)
    if method == METHOD.EUCLIDEAN:
        ids = piecewise_index(np.round(np.sqrt((diff ** 2).sum(-1).astype(np.float64))), **kw) + beta_int
    elif method == METHOD.QUANT:
        ids = piecewise_index((diff ** 2).sum(-1), **kw) + beta_int
    elif method == METHOD.PRODUCT:
        S = 2 * beta_int + 1
        r = piecewise_index(diff[..., 0], **kw) + beta_int
        c = piecewise_index(diff[..., 1], **kw) + beta_int
        ids = r * S + c
    elif method == METHOD.CROSS_ROWS:
        ids = piecewise_index(diff[..., 0], **kw) + beta_int
    elif method == METHOD.CROSS_COLS:
        ids = piecewise_index(diff[..., 1], **kw) + beta_int
    else:
        raise NotImplementedError(f"method {method}")

    n = num_buckets(method, beta, skip=0)
    if skip > 0:
        L = height * width
        full = np.full((skip + L, skip + L), n, dtype=np.int64)
        full[skip:, skip:] = ids
        ids = full
        n += 1
    return ids.astype(np.int32), n


@dataclasses.dataclass(frozen=True)
class SingleRPEConfig:
    method: int
    mode: str                     # 'bias' | 'contextual'
    shared_head: bool
    skip: int
    alpha: float
    beta: float
    gamma: float

    @property
    def num_buckets(self) -> int:
        return num_buckets(self.method, self.beta, self.skip)


@dataclasses.dataclass(frozen=True)
class RPEConfig:
    rpe_q: SingleRPEConfig | None
    rpe_k: SingleRPEConfig | None
    rpe_v: SingleRPEConfig | None


def get_rpe_config(ratio: float = 1.9, method="product", mode: str = "contextual",
                   shared_head: bool = True, skip: int = 0,
                   rpe_on: str = "k") -> RPEConfig:
    """irpe.py:823-887: alpha, beta, gamma = (1, 2, 8) · ratio; `rpe_on`
    names the attention inputs that get an encoding ('k', 'qk', 'qkv')."""
    if isinstance(method, str):
        method = _METHOD_NAMES[method.lower()]
    if mode == "ctx":
        mode = "contextual"
    single = SingleRPEConfig(method=method, mode=mode, shared_head=shared_head,
                             skip=skip, alpha=1 * ratio, beta=2 * ratio,
                             gamma=8 * ratio)
    return RPEConfig(
        rpe_q=single if "q" in rpe_on else None,
        rpe_k=single if "k" in rpe_on else None,
        rpe_v=single if "v" in rpe_on else None,
    )
