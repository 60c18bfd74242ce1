"""iRPE: learned relative position encodings over bucket tables.

Counterpart of `cream_tpu/nn/rpe.py` (the iRPE module of
iRPE/DeiT-with-iRPE/irpe.py:418-767 and its CUDA gather `rpe_index`). An
`IRPE` is built for one token grid: its bucket table (and, on values, the
one-hot of it) is a non-persistent buffer made once, on the module's device.

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

from cream_tpu_torch.ops.rpe import METHOD, SingleRPEConfig, bucket_ids_2d


class IRPE(nn.Module):
    """One directional RPE (on q, k or v) for a `height` x `width` grid after
    `skip` prefix tokens (`cfg.skip` unless given: a distilled DeiT has 2).
    Input: (B, heads, L, head_dim) when `transposed`, the (B, heads, L, L)
    attention matrix otherwise; L = skip + height·width."""

    def __init__(self, head_dim: int, num_heads: int, cfg: SingleRPEConfig,
                 height: int, width: int, skip: int | None = None,
                 transposed: bool = True, *, dtype: torch.dtype = torch.float32,
                 device=None):
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
        ids, n = bucket_ids_2d(cfg.method, height, width, skip, cfg.alpha, cfg.beta,
                               cfg.gamma)
        if skip > 0 and n != cfg.num_buckets:
            raise ValueError(f"{n} buckets at skip {skip}, the config has {cfg.num_buckets}")
        tables = 1 if cfg.shared_head else num_heads
        ids = torch.as_tensor(ids, dtype=torch.long, device=device)
        self.register_buffer("bucket_ids", ids, persistent=False)
        if cfg.mode == "bias":
            self.lookup_table_bias = nn.Parameter(torch.zeros(tables, n, device=device))
        elif transposed:
            self.lookup_table_weight = nn.Parameter(
                torch.zeros(tables, head_dim, n, device=device))
        else:
            self.lookup_table_weight = nn.Parameter(
                torch.zeros(tables, n, head_dim, device=device))
            self.register_buffer("onehot", F.one_hot(ids, n).float(), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.method == METHOD.CROSS:
            return self.rp_rows(x) + self.rp_cols(x)
        L = self.bucket_ids.shape[0]
        if x.shape[2] != L or (not self.transposed and x.shape[3] != L):
            raise ValueError(f"input {tuple(x.shape)}: the table was built for {L} tokens")
        dt = self.dtype
        if self.cfg.mode == "bias":
            return self.lookup_table_bias[:, self.bucket_ids][None].to(dt)   # (1, h|1, L, L)
        w = self.lookup_table_weight.to(dt).float()
        if self.transposed:
            tbl = torch.matmul(x.float(), w)                                   # (B, h, L, n)
            idx = self.bucket_ids.expand(*tbl.shape[:-1], L)
            return torch.gather(tbl, 3, idx).to(dt)
        z = torch.einsum("bhij,ijn->bhin", x.float(), self.onehot).to(dt)
        return torch.matmul(z.float(), w).to(dt)
