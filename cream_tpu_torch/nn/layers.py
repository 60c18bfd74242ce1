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
  * a depthwise 3x3 ConvBN can run its conv through the kernels of
    `ops/dwconv.py` (`ConvBN.dw_kernel`, `set_dw_kernel`); an eval MBConv
    can run as one fused op, `ops/mbconv.py` (`MBConv.use_kernel`,
    `set_mbconv_kernel`)
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from cream_tpu_torch.nn.act import gelu
from cream_tpu_torch.ops import dwconv, mbconv
from cream_tpu_torch.ops.common import drop_path, dropout
from cream_tpu_torch.ops.fuse import cached_fold

# depthwise 3x3 conv routes (the JAX package's `ConvBN.dw_vjp` values False,
# True and "wgrad")
DW_KERNELS = ("library", "fused", "wgrad")


def layer_norm(norm: nn.LayerNorm, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.layer_norm(x, norm.normalized_shape, norm.weight.to(dtype),
                        norm.bias.to(dtype), norm.eps)


def linear(fc: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    bias = None if fc.bias is None else fc.bias.to(dtype)
    return F.linear(x, fc.weight.to(dtype), bias)


def _check_dw_kernel(mode: str) -> None:
    if mode not in DW_KERNELS:
        raise ValueError(f"dw_kernel must be one of {DW_KERNELS}, got {mode!r}")


def batch_norm_train(bn: nn.modules.batchnorm._BatchNorm, y: torch.Tensor,
                     momentum: float) -> torch.Tensor:
    """Train-mode BatchNorm over every dim but dim 1, as flax does it:
    normalise with the batch mean and biased variance, computed in fp32
    whatever y's dtype (the output stays in y's dtype), and update the
    running stats as `r = momentum*r + (1-momentum)*batch` with the *biased*
    variance. (`F.batch_norm(training=True)` would put the unbiased one into
    `running_var`.)"""
    y, mean, invstd = torch.native_batch_norm(y, bn.weight, bn.bias, None, None, True,
                                              0.0, bn.eps)
    with torch.no_grad():
        var = invstd.pow(-2) - bn.eps                  # biased variance
        bn.running_mean.mul_(momentum).add_(mean, alpha=1 - momentum)
        bn.running_var.mul_(momentum).add_(var, alpha=1 - momentum)
        bn.num_batches_tracked += 1
    return y


class ConvBN(nn.Module):
    """Conv2d(bias=False) + BatchNorm on an NHWC map. `groups=features` gives
    a depthwise conv.

    In train mode BatchNorm normalizes with the batch mean and biased
    variance, computed in fp32 whatever the compute dtype, and updates the
    running stats as flax does (`batch_norm_train`, torch momentum 0.1).

    `dw_kernel` routes a depthwise 3x3 pad-1 conv (stride 1 or 2, groups ==
    features == input channels) as the JAX package's `dw_vjp` does:
      "library" (default): `F.conv2d`, forward and autograd backward;
      "fused": stride 1 through `dwconv.dw_conv3x3_fused` (K7) where
          `supports_fused`; stride 2 through `dwconv.dw_conv3x3s2_fused`
          (K9) where `supports_fused_s2`; else the library conv;
      "wgrad": stride 1 through `dwconv.dw_conv3x3_wg` (library forward and
          dx, K8 weight grad) where `supports_fused`; stride 2 on the
          library conv (JAX has no stride-2 wgrad route).
    The kernels take and return NHWC; BatchNorm runs on the NCHW view."""

    MOMENTUM = 0.9        # flax's convention: the weight of the old value

    def __init__(self, in_features: int, features: int, kernel_size: int = 1,
                 stride: int = 1, padding: int = 0, groups: int = 1,
                 bn_weight_init: float = 1.0, *, dw_kernel: str = "library",
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        _check_dw_kernel(dw_kernel)
        self.stride, self.padding, self.groups = stride, padding, groups
        self.dtype = dtype
        self.dw_kernel = dw_kernel
        self.c = nn.Conv2d(in_features, features, kernel_size, stride, padding,
                           groups=groups, bias=False, device=device)
        self.bn = nn.BatchNorm2d(features, eps=1e-5, device=device)
        nn.init.constant_(self.bn.weight, bn_weight_init)

    def is_dw3x3(self) -> bool:
        """A depthwise 3x3 pad-1 conv of stride 1 or 2: the kernels' sites."""
        c = self.c
        return (c.kernel_size == (3, 3) and self.padding == 1 and self.stride in (1, 2)
                and self.groups == c.out_channels == c.in_channels)

    def _dw_route(self, x: torch.Tensor):
        """The kernel route's function for this input, or None for the
        library conv."""
        if self.dw_kernel == "library" or not self.is_dw3x3() \
                or x.shape[-1] != self.c.out_channels:
            return None
        if self.stride == 1:
            if not dwconv.supports_fused(x.shape):
                return None
            return dwconv.dw_conv3x3_fused if self.dw_kernel == "fused" else dwconv.dw_conv3x3_wg
        if self.dw_kernel == "fused" and dwconv.supports_fused_s2(x.shape):
            return dwconv.dw_conv3x3s2_fused
        return None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        route = self._dw_route(x)
        if route is None:
            y = F.conv2d(x.permute(0, 3, 1, 2), self.c.weight.to(self.dtype), None,
                         self.stride, self.padding, 1, self.groups)
        else:
            # the taps in the compute dtype, as the JAX package's _DWConv3x3
            # hands them over: the weight grad rounds to it too
            w9 = self.c.weight.to(self.dtype).reshape(-1, 9).t()
            y = route(x.contiguous(), w9).permute(0, 3, 1, 2)
        bn = self.bn
        if not self.training:
            y = F.batch_norm(y, bn.running_mean, bn.running_var, bn.weight,
                             bn.bias, False, 0.0, bn.eps)
        else:
            y = batch_norm_train(bn, y, self.MOMENTUM)
        return y.permute(0, 2, 3, 1)


def set_dw_kernel(model: nn.Module, mode: str) -> None:
    """Route every ConvBN of `model` through `mode` (see `ConvBN`): the
    counterpart of setting the JAX package's `DEFAULT_DW_VJP`. Only the
    depthwise 3x3 sites change behaviour."""
    _check_dw_kernel(mode)
    for m in model.modules():
        if isinstance(m, ConvBN):
            m.dw_kernel = mode


class BNLinear(nn.Module):
    """BatchNorm1d on the features, then Linear: the EfficientViT classifier
    head (released names `bn`, `l`). In train mode the BN takes the batch's
    statistics and updates its running stats as `ConvBN` does."""

    def __init__(self, in_features: int, out_features: int, *,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.bn = nn.BatchNorm1d(in_features, eps=1e-5, device=device)
        self.l = nn.Linear(in_features, out_features, device=device)
        nn.init.trunc_normal_(self.l.weight, std=0.02)
        nn.init.zeros_(self.l.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bn = self.bn
        x = x.to(self.dtype)
        if self.training:
            x = batch_norm_train(bn, x, ConvBN.MOMENTUM)
        else:
            x = F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                             False, 0.0, bn.eps)
        return linear(self.l, x, self.dtype)


class MBConv(nn.Module):
    """Inverted-residual MBConv: 1x1 expand → 3x3 depthwise → 1x1 project,
    all Conv+BN with GELU between, drop path (train), residual add then
    GELU.

    `use_kernel` (the JAX package's `use_pallas`, off by default): in eval
    and outside autograd, when x has `features` channels and K6 takes the
    shape (`ops.mbconv.supports_shape`), the block runs as one op,
    `ops.mbconv.fused_mbconv` on the BN-folded weights (`folded`, cached
    until a parameter or buffer changes): K6 on CUDA tensors, its plain
    version on CPU tensors. The fused op has no backward, as in JAX."""

    def __init__(self, features: int, expand_ratio: float = 4.0,
                 drop_path_rate: float = 0.0, use_kernel: bool = False, *,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.features = features
        self.drop_path_rate = drop_path_rate
        self.use_kernel = use_kernel
        self.dtype = dtype
        self.hidden = int(features * expand_ratio)
        kw = dict(dtype=dtype, device=device)
        self.conv1 = ConvBN(features, self.hidden, 1, **kw)
        self.conv2 = ConvBN(self.hidden, self.hidden, 3, 1, 1, groups=self.hidden, **kw)
        self.conv3 = ConvBN(self.hidden, features, 1, bn_weight_init=0.0, **kw)

    def kernel_path(self, x: torch.Tensor) -> bool:
        """Whether `forward(x)` runs the fused op."""
        return (self.use_kernel and not self.training and not torch.is_grad_enabled()
                and x.shape[-1] == self.features
                and mbconv.supports_shape(x.shape, self.hidden, self.dtype))

    def folded(self) -> tuple[torch.Tensor, ...]:
        """`ops.mbconv.fold_mbconv(self, self.dtype)`, cached until a
        parameter or buffer changes."""
        return cached_fold(self, mbconv.fold_mbconv)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if self.kernel_path(x):
            return mbconv.fused_mbconv(x.to(self.dtype).contiguous(), *self.folded())
        shortcut = x
        x = gelu(self.conv1(x))
        x = gelu(self.conv2(x))
        x = self.conv3(x)
        x = drop_path(x, self.drop_path_rate, not self.training, generator)
        return gelu(x + shortcut)


def set_mbconv_kernel(model: nn.Module, on: bool) -> None:
    """Turn the fused route of every MBConv of `model` on or off (see
    `MBConv.use_kernel`)."""
    for m in model.modules():
        if isinstance(m, MBConv):
            m.use_kernel = on


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
