"""iRPE: learned relative position encodings over bucket tables.

Counterpart of `cream_tpu/nn/rpe.py` (the iRPE module of
iRPE/DeiT-with-iRPE/irpe.py:418-767 and its CUDA gather `rpe_index`). An
`IRPE` built for a token grid keeps its bucket table (and, on values, the
one-hot of it) as a non-persistent buffer made once, on the module's device;
`forward(x, hw=(H, W))` takes another grid (DETR's encoder sees the
stride-32 grid of whatever canvas comes in), whose tables are made on the
first call and cached per (H, W, device). The parameter's shape depends on
the method and beta only, so one parameter serves every grid.

  * bias mode: a scalar per bucket, `table[:, bucket[i, j]]`.
  * contextual on q or k (`transposed`): `tbl = x·W` (fp32 sums of products
    of compute-dtype values), then `Y[b,h,i,j] = tbl[b,h,i,bucket[i,j]]`,
    a `torch.gather` through the (L, L) table broadcast with `expand` (no
    (B, h, L, L) index is made; the backward is a scatter-add).
  * contextual on values (not transposed; x is the attention matrix): the
    bucket aggregation `z[b,h,i,n] = Σ_j x[b,h,i,j]·[bucket[i,j] = n]`
    against the constant one-hot, then `z·W`.

Rounding points are the JAX package's: fp32 sums, each result cast to the
compute dtype. `shared_head` keeps one table for all heads. The cross method
is two children, `rp_rows` and `rp_cols`, summed. Parameter names are the
reference's (`lookup_table_weight`, `lookup_table_bias`), zero-initialized.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from cream_tpu_torch.ops.rpe import METHOD, SingleRPEConfig, bucket_ids_2d, num_buckets


class IRPE(nn.Module):
    """One directional RPE (on q, k or v) for a `height` x `width` grid after
    `skip` prefix tokens (`cfg.skip` unless given: a distilled DeiT has 2).
    Input: (B, heads, L, head_dim) when `transposed`, the (B, heads, L, L)
    attention matrix otherwise; L = skip + height·width. Without a grid
    (`height`, `width` None) every call names its own (`hw`)."""

    def __init__(self, head_dim: int, num_heads: int, cfg: SingleRPEConfig,
                 height: int | None = None, width: int | None = None,
                 skip: int | None = None, transposed: bool = True, *,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.cfg, self.transposed, self.dtype = cfg, transposed, dtype
        skip = cfg.skip if skip is None else skip
        if cfg.method == METHOD.CROSS:
            kw = dict(skip=skip, transposed=transposed, dtype=dtype, device=device)
            self.rp_rows = IRPE(head_dim, num_heads,
                                dataclasses.replace(cfg, method=METHOD.CROSS_ROWS),
                                height, width, **kw)
            self.rp_cols = IRPE(head_dim, num_heads,
                                dataclasses.replace(cfg, method=METHOD.CROSS_COLS),
                                height, width, **kw)
            return
        if not transposed and cfg.mode != "contextual":
            raise ValueError("bias mode is transposed-only")
        self.skip = skip
        n = num_buckets(cfg.method, cfg.beta, skip)
        if skip > 0 and n != cfg.num_buckets:
            raise ValueError(f"{n} buckets at skip {skip}, the config has {cfg.num_buckets}")
        self._grids: dict[tuple, tuple] = {}
        tables = 1 if cfg.shared_head else num_heads
        if height is not None:
            ids, onehot = self._tables(height, width, device)
            self.register_buffer("bucket_ids", ids, persistent=False)
            if onehot is not None:
                self.register_buffer("onehot", onehot, persistent=False)
        if cfg.mode == "bias":
            self.lookup_table_bias = nn.Parameter(torch.zeros(tables, n, device=device))
        elif transposed:
            self.lookup_table_weight = nn.Parameter(
                torch.zeros(tables, head_dim, n, device=device))
        else:
            self.lookup_table_weight = nn.Parameter(
                torch.zeros(tables, n, head_dim, device=device))

    def _tables(self, height: int, width: int, device) -> tuple:
        """(bucket ids (L, L) long, their one-hot (L, L, n) fp32 on values
        else None) of a grid, made outside inference mode (autograd saves
        them for the backward)."""
        cfg = self.cfg
        ids, n = bucket_ids_2d(cfg.method, height, width, self.skip, cfg.alpha, cfg.beta,
                               cfg.gamma)
        with torch.inference_mode(False):
            ids = torch.as_tensor(ids, dtype=torch.long, device=device)
            onehot = None if self.transposed else F.one_hot(ids, n).float()
        return ids, onehot

    def forward(self, x: torch.Tensor, hw: tuple[int, int] | None = None) -> torch.Tensor:
        if self.cfg.method == METHOD.CROSS:
            return self.rp_rows(x, hw) + self.rp_cols(x, hw)
        if hw is None:
            ids, onehot = self.bucket_ids, getattr(self, "onehot", None)
        else:
            key = (int(hw[0]), int(hw[1]), x.device)
            if key not in self._grids:
                self._grids[key] = self._tables(key[0], key[1], x.device)
            ids, onehot = self._grids[key]
        return self._encode(x, ids, onehot)

    def _encode(self, x: torch.Tensor, ids: torch.Tensor, onehot) -> torch.Tensor:
        L = ids.shape[0]
        if x.shape[2] != L or (not self.transposed and x.shape[3] != L):
            raise ValueError(f"input {tuple(x.shape)}: the table was built for {L} tokens")
        dt = self.dtype
        if self.cfg.mode == "bias":
            return self.lookup_table_bias[:, ids][None].to(dt)               # (1, h|1, L, L)
        w = self.lookup_table_weight.to(dt).float()
        if self.transposed:
            tbl = torch.matmul(x.float(), w)                                   # (B, h, L, n)
            idx = ids.expand(*tbl.shape[:-1], L)
            return torch.gather(tbl, 3, idx).to(dt)
        z = torch.einsum("bhij,ijn->bhin", x.float(), onehot).to(dt)
        return torch.matmul(z.float(), w).to(dt)
