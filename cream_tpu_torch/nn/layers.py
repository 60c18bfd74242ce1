"""Core building blocks, NHWC, eval and train.

Counterparts of `cream_tpu/nn/layers.py`'s ConvBN, MBConv and MlpLN. Parameter
names follow the released microsoft/Cream TinyViT checkpoints (`c`/`bn` in a
Conv2d_BN, `norm`/`fc1`/`fc2` in the MLP), so those state_dicts load as they
are.

Conventions:
  * activations are NHWC at every public forward; a convolution sees the NCHW
    view `x.permute(0, 3, 1, 2)`, which has channels_last strides, so cuDNN
    takes it without a copy
  * params stay float32; compute runs in the module's `dtype` (weights are
    cast per call)
  * eval (`module.eval()`): BatchNorm uses its running statistics (eps
    1e-5). train (`module.train()`): the batch's statistics, as flax
    `BatchNorm(use_running_average=False)` does (see `ConvBN`); drop path
    and dropout draw from the generator the caller passes to `forward`
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from cream_tpu_torch.nn.act import gelu
from cream_tpu_torch.ops.common import drop_path, dropout


def layer_norm(norm: nn.LayerNorm, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.layer_norm(x, norm.normalized_shape, norm.weight.to(dtype),
                        norm.bias.to(dtype), norm.eps)


def linear(fc: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    bias = None if fc.bias is None else fc.bias.to(dtype)
    return F.linear(x, fc.weight.to(dtype), bias)


class ConvBN(nn.Module):
    """Conv2d(bias=False) + BatchNorm on an NHWC map. `groups=features` gives
    a depthwise conv.

    In train mode BatchNorm normalizes with the batch mean and biased
    variance, computed in fp32 whatever the compute dtype, and updates the
    running stats as flax does: `r = 0.9*r + 0.1*batch` (torch momentum
    0.1) with the *biased* variance. (`F.batch_norm(training=True)` would put
    the unbiased one into `running_var`.)"""

    MOMENTUM = 0.9        # flax's convention: the weight of the old value

    def __init__(self, in_features: int, features: int, kernel_size: int = 1,
                 stride: int = 1, padding: int = 0, groups: int = 1,
                 bn_weight_init: float = 1.0, *,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.stride, self.padding, self.groups = stride, padding, groups
        self.dtype = dtype
        self.c = nn.Conv2d(in_features, features, kernel_size, stride, padding,
                           groups=groups, bias=False, device=device)
        self.bn = nn.BatchNorm2d(features, eps=1e-5, device=device)
        nn.init.constant_(self.bn.weight, bn_weight_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x.to(self.dtype).permute(0, 3, 1, 2),
                     self.c.weight.to(self.dtype), None, self.stride,
                     self.padding, 1, self.groups)
        bn = self.bn
        if not self.training:
            y = F.batch_norm(y, bn.running_mean, bn.running_var, bn.weight,
                             bn.bias, False, 0.0, bn.eps)
            return y.permute(0, 2, 3, 1)
        # batch stats in fp32 (the accumulation type for a bf16 input); the
        # output is in the compute dtype
        y, mean, invstd = torch.native_batch_norm(y, bn.weight, bn.bias, None,
                                                  None, True, 0.0, bn.eps)
        with torch.no_grad():
            var = invstd.pow(-2) - bn.eps                  # biased variance
            bn.running_mean.mul_(self.MOMENTUM).add_(mean, alpha=1 - self.MOMENTUM)
            bn.running_var.mul_(self.MOMENTUM).add_(var, alpha=1 - self.MOMENTUM)
            bn.num_batches_tracked += 1
        return y.permute(0, 2, 3, 1)


class MBConv(nn.Module):
    """Inverted-residual MBConv: 1x1 expand → 3x3 depthwise → 1x1 project,
    all Conv+BN with GELU between, drop path (train), residual add then
    GELU."""

    def __init__(self, features: int, expand_ratio: float = 4.0,
                 drop_path_rate: float = 0.0, *,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.drop_path_rate = drop_path_rate
        hidden = int(features * expand_ratio)
        kw = dict(dtype=dtype, device=device)
        self.conv1 = ConvBN(features, hidden, 1, **kw)
        self.conv2 = ConvBN(hidden, hidden, 3, 1, 1, groups=hidden, **kw)
        self.conv3 = ConvBN(hidden, features, 1, bn_weight_init=0.0, **kw)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        shortcut = x
        x = gelu(self.conv1(x))
        x = gelu(self.conv2(x))
        x = self.conv3(x)
        x = drop_path(x, self.drop_path_rate, not self.training, generator)
        return gelu(x + shortcut)


class MlpLN(nn.Module):
    """LayerNorm → Dense → GELU → dropout → Dense → dropout (TinyViT-style
    MLP with leading LN). Dropout is the identity in eval."""

    def __init__(self, in_features: int, hidden_features: int,
                 out_features: int, dropout: float = 0.0, *,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.dropout = dropout
        self.norm = nn.LayerNorm(in_features, eps=1e-5, device=device)
        self.fc1 = nn.Linear(in_features, hidden_features, device=device)
        self.fc2 = nn.Linear(hidden_features, out_features, device=device)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = layer_norm(self.norm, x.to(self.dtype), self.dtype)
        x = gelu(linear(self.fc1, x, self.dtype))
        x = dropout(x, self.dropout, not self.training, generator)
        x = linear(self.fc2, x, self.dtype)
        return dropout(x, self.dropout, not self.training, generator)
