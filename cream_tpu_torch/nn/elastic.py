"""Elastic (weight-entangled) layers for one-shot supernets.

Counterpart of `cream_tpu/nn/elastic.py`. The JAX package runs its
supernet at the super widths and masks the inactive prefix of every channel
dim, so that one compiled program serves every config. Eager PyTorch pays
nothing for a new config, so the port does what the reference does
(AutoFormer/model/module/Linear_super.py:71-75, qkv_super.py:72-77):
every call slices views of the super weights to the active widths,

    y = x[..., :in] W[:out, :in]ᵀ + b[:out]     ==     (x·m_in) W · m_out

The two agree in exact arithmetic: masked inputs add zeros, masked outputs
are zeros, and the masked LayerNorm's statistics over the active prefix are
the sliced LayerNorm's. A slice's backward writes zeros into the inactive
rows and columns of the super weights' grads, as the masks' do in JAX. The
modules hold the full super weights under the reference's names, so one
model object serves every config and a reference supernet `.pth` loads into
it as it is.

`slice_*` materialise the sliced weights of one config for a fixed subnet,
the qkv rows in the reference's interleaved order (q0, k0, v0, q1, ...)
regrouped as [q; k; v].
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class ElasticLinear(nn.Linear):
    """Linear at super dims; `forward(x, out_dim, dtype)` applies
    weight[:out_dim, :in] (in = x's last dim) and bias[:out_dim] in
    `dtype`."""

    def forward(self, x: torch.Tensor, out_dim: int, dtype: torch.dtype) -> torch.Tensor:
        w = self.weight[:out_dim, :x.shape[-1]].to(dtype)
        b = None if self.bias is None else self.bias[:out_dim].to(dtype)
        return F.linear(x, w, b)


class ElasticLayerNorm(nn.LayerNorm):
    """LayerNorm over the active prefix (x's last dim), eps 1e-5, computed
    in fp32 whatever x's dtype and cast to `dtype`, as JAX's masked
    statistics are."""

    def __init__(self, super_dim: int, *, device=None):
        super().__init__(super_dim, eps=1e-5, device=device)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        d = x.shape[-1]
        return F.layer_norm(x.float(), (d,), self.weight[:d], self.bias[:d],
                            self.eps).to(dtype)


def qkv_rows(out_dim: int) -> torch.Tensor:
    """The rows of an interleaved qkv weight that a [q; k; v] layout of
    width `out_dim` (= 3 x active units) takes: every third row from 0, 1
    and 2 below `out_dim` (qkv_super.py:75)."""
    return torch.cat([torch.arange(i, out_dim, 3) for i in range(3)])


def slice_linear(weight: torch.Tensor, bias: torch.Tensor | None, in_dim: int,
                 out_dim: int) -> tuple[torch.Tensor, torch.Tensor | None]:
    return (weight[:out_dim, :in_dim].clone(),
            None if bias is None else bias[:out_dim].clone())


def slice_qkv_interleaved(weight: torch.Tensor, bias: torch.Tensor | None, in_dim: int,
                          out_dim: int) -> tuple[torch.Tensor, torch.Tensor | None]:
    """An interleaved (3·super_units, super_in) qkv weight sliced to
    (out_dim, in_dim) with the rows regrouped as [q; k; v]."""
    rows = qkv_rows(out_dim).to(weight.device)
    return (weight[rows, :in_dim].clone(), None if bias is None else bias[rows].clone())


def slice_layer_norm(weight: torch.Tensor, bias: torch.Tensor, dim: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    return weight[:dim].clone(), bias[:dim].clone()
