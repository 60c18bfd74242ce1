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
    `BatchNorm(use_running_average=False)` does (see `ConvBN`), the global
    batch's under a data-parallel group (`batch_norm_train`); drop path
    and dropout draw from the generator the caller passes to `forward`
  * a depthwise 3x3 ConvBN can run its conv through the kernels of
    `ops/dwconv.py` (`ConvBN.dw_kernel`, `set_dw_kernel`); the JAX
    package's two gates, off by default: `DEFAULT_CONV1X1_DOT` (a 1x1
    conv as a channel product) and `ops.bn.DEFAULT_MXU_BN` (train-mode BN
    through `ops.bn.bn_train_norm`, `MXUBatchNorm`); an eval MBConv
    can run as one fused op, `ops/mbconv.py` (`MBConv.use_kernel`,
    `set_mbconv_kernel`)
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from cream_tpu_torch.core.mesh import data_group
from cream_tpu_torch.nn.act import gelu
from cream_tpu_torch.ops import bn as bn_ops
from cream_tpu_torch.ops import dwconv, mbconv
from cream_tpu_torch.ops.common import drop_path, dropout
from cream_tpu_torch.ops.fuse import cached_fold

# depthwise 3x3 conv routes (the JAX package's `ConvBN.dw_vjp` values False,
# True and "wgrad")
DW_KERNELS = ("library", "fused", "wgrad")

# Route stride-s 1x1 groups-1 pad-0 ConvBN convs through an explicit channel
# product (x[:, ::s, ::s] @ W) instead of the library conv: the JAX package's
# A/B knob of the same name (an XLA layout experiment there), off by
# default. The weight stays the conv's `c.weight`, so state_dicts load
# either way.
DEFAULT_CONV1X1_DOT = False


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
    `running_var`.) Under a data-parallel group the batch is the global one
    (`GlobalBatchNorm`), as flax's mean over a sharded batch is."""
    if data_group() is not None:
        y, mean, var = GlobalBatchNorm.apply(y, bn.weight, bn.bias, bn.eps)
    else:
        y, mean, invstd = torch.native_batch_norm(y, bn.weight, bn.bias, None, None, True,
                                                  0.0, bn.eps)
        var = invstd.detach().pow(-2) - bn.eps          # biased variance
    with torch.no_grad():
        bn.running_mean.mul_(momentum).add_(mean, alpha=1 - momentum)
        bn.running_var.mul_(momentum).add_(var, alpha=1 - momentum)
        bn.num_batches_tracked += 1
    return y


def mxu_batch_norm_train(bn: nn.modules.batchnorm._BatchNorm, y: torch.Tensor,
                         momentum: float) -> torch.Tensor:
    """`batch_norm_train` through `ops.bn.bn_train_norm` (the JAX package's
    `MXUBatchNorm`): the batch moments in fp32 (the one-pass variance), the
    normalisation's backward folded into dx, the running stats updated as
    flax does (biased variance). y's channels are dim 1. Its forward and
    backward run inside `record_function("mxu_batch_norm")`, which
    `cli.profile_step.profile(ranges=)` reads. Under a
    data-parallel group the moments are the global batch's, which
    `GlobalBatchNorm` computes (flax's mean over a sharded batch)."""
    if data_group() is not None:
        return batch_norm_train(bn, y, momentum)
    with torch.profiler.record_function("mxu_batch_norm"):
        mean, var = bn_ops._moments(y, 1)
        out = bn_ops.bn_train_norm(y, mean, var, bn.weight, bn.bias, bn.eps, channel_dim=1)
        with torch.no_grad():
            bn.running_mean.mul_(momentum).add_(mean, alpha=1 - momentum)
            bn.running_var.mul_(momentum).add_(var, alpha=1 - momentum)
            bn.num_batches_tracked += 1
    return out


class MXUBatchNorm(nn.BatchNorm2d):
    """BatchNorm2d whose train mode is `mxu_batch_norm_train` with flax's
    momentum (0.9 the weight of the old value) and biased running variance;
    eval mode on the running statistics. The counterpart of the JAX
    package's `MXUBatchNorm`, with BatchNorm2d's state names, so a state
    dict loads into either class."""

    MOMENTUM = 0.9

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        if self.training:
            return mxu_batch_norm_train(self, y, self.MOMENTUM)
        return F.batch_norm(y, self.running_mean, self.running_var, self.weight, self.bias,
                            False, 0.0, self.eps)


def _channel_view(t: torch.Tensor, ndim: int) -> torch.Tensor:
    return t.view((1, -1) + (1,) * (ndim - 2))


class GlobalBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm of this rank's rows with the moments of the
    global batch (SyncBN): each rank's fp32 sums and sums of squares over
    every dim but dim 1, and its count, are summed over the group in one
    all-reduce, and the variance is flax's fast one, E[x^2] - E[x]^2. The
    backward sums the grads' two channel sums over the group in one
    all-reduce, so each rank's input grad is the gradient of the ranks'
    summed loss; the weight and bias grads are this rank's share, which the
    data-parallel step averages with the rest. Returns (y, mean, biased
    variance), the last two without grad. weight and bias may be None.

    On a CUDA tensor the per-rank passes are ATen's fused SyncBN kernels
    (`batch_norm_stats`: the rank's moments in one fp32 pass, from which its
    sums are formed; `batch_norm_elemt`; `batch_norm_backward_reduce` and
    `_elemt`), which read y in its own dtype; elsewhere the same arithmetic
    is written out in fp32 (`_plain_*`), and `tests/test_torch_cuda.py`
    holds the first to the second."""

    @staticmethod
    def forward(ctx, y, weight, bias, eps):
        with torch.profiler.record_function("global_batch_norm"):
            C, n = y.shape[1], y.numel() // y.shape[1]
            sums = _local_sums(y)
            stats = torch.cat([sums, sums.new_full((1,), float(n))])
            torch.distributed.all_reduce(stats)
            count = stats[2 * C]
            mean = stats[:C] / count
            var = (stats[C:2 * C] / count - mean * mean).clamp_min(0.0)
            invstd = torch.rsqrt(var + eps)
            out = _normalize(y, weight, bias, mean, invstd, eps)
            ctx.save_for_backward(y, weight, mean, invstd, count)
            ctx.bias_dtype = None if bias is None else bias.dtype
            ctx.mark_non_differentiable(mean, var)
            return out, mean, var

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout, _dmean, _dvar):
        y, weight, mean, invstd, count = ctx.saved_tensors
        with torch.profiler.record_function("global_batch_norm"):
            C = y.shape[1]
            # this rank's sum(dy) and sum(dy * (x - mean)), and its weight and
            # bias grads
            sum_dy, sum_dy_xmu, dweight, dbias = _backward_reduce(
                dout, y, weight, mean, invstd, ctx.bias_dtype is not None)
            sums = torch.cat([sum_dy, sum_dy_xmu])
            torch.distributed.all_reduce(sums)
            dx = _backward_elemt(dout, y, weight, mean, invstd, sums[:C], sums[C:], count)
            return dx, dweight, dbias, None


def _local_sums(y: torch.Tensor) -> torch.Tensor:
    """This rank's fp32 sum and sum of squares per channel (dim 1), as one
    (2C,) tensor."""
    n = y.numel() // y.shape[1]
    if y.is_cuda:
        mean, invstd = torch.batch_norm_stats(y, 0.0)
        return torch.cat([mean * n, (invstd.pow(-2) + mean * mean) * n])
    x = y.float()
    dims = [d for d in range(y.ndim) if d != 1]
    return torch.cat([x.sum(dims), (x * x).sum(dims)])


def _normalize(y, weight, bias, mean, invstd, eps) -> torch.Tensor:
    """w * (x - mean) * invstd + b in fp32, in y's dtype."""
    if y.is_cuda:
        return torch.batch_norm_elemt(y, weight, bias, mean, invstd, eps)
    view = lambda t: _channel_view(t, y.ndim)
    out = (y.float() - view(mean)) * view(invstd)
    if weight is not None:
        out = out * view(weight)
    if bias is not None:
        out = out + view(bias)
    return out.to(y.dtype)


def _backward_reduce(dout, y, weight, mean, invstd, has_bias: bool):
    """(sum dy, sum dy * (x - mean), weight grad, bias grad) of this rank."""
    if y.is_cuda:
        sum_dy, sum_dy_xmu, dweight, dbias = torch.batch_norm_backward_reduce(
            dout, y, mean, invstd, weight, True, weight is not None, has_bias)
        return (sum_dy, sum_dy_xmu, dweight if weight is not None else None,
                dbias if has_bias else None)
    dims = [d for d in range(y.ndim) if d != 1]
    g, xmu = dout.float(), y.float() - _channel_view(mean, y.ndim)
    sum_dy, sum_dy_xmu = g.sum(dims), (g * xmu).sum(dims)
    dweight = None if weight is None else (sum_dy_xmu * invstd).to(weight.dtype)
    return sum_dy, sum_dy_xmu, dweight, sum_dy if has_bias else None


def _backward_elemt(dout, y, weight, mean, invstd, sum_dy, sum_dy_xmu, count) -> torch.Tensor:
    """The input grad from the group's sums: (dy - sum_dy / N - (x - mean)
    * invstd^2 * sum_dy_xmu / N) * invstd * w, in y's dtype."""
    if y.is_cuda:
        return torch.batch_norm_backward_elemt(dout, y, mean, invstd, weight, sum_dy,
                                               sum_dy_xmu, count.int().reshape(1))
    view = lambda t: _channel_view(t, y.ndim)
    mul = invstd if weight is None else invstd * weight
    xmu = y.float() - view(mean)
    dx = (dout.float() - view(sum_dy / count)
          - xmu * view(invstd * invstd * sum_dy_xmu / count)) * view(mul)
    return dx.to(y.dtype)


# depthwise sites a kernel route refused by shape, so they ran the library
# conv: (route, stride, shape) -> calls since import (or since a reset)
DW_REFUSED: dict[tuple, int] = {}


def is_dw3x3(conv: nn.Conv2d, stride: int, padding: int, groups: int) -> bool:
    """A depthwise 3x3 pad-1 conv of stride 1 or 2: the kernels' sites."""
    return (conv.kernel_size == (3, 3) and padding == 1 and stride in (1, 2)
            and groups == conv.out_channels == conv.in_channels)


def dw_route(mode: str, conv: nn.Conv2d, stride: int, padding: int, groups: int,
             x: torch.Tensor):
    """The kernel function that route `mode` takes for the conv `conv` on the
    NHWC input x, or None for the library conv (see `ConvBN`). A depthwise
    3x3 site whose shape the kernel refuses is counted in `DW_REFUSED`."""
    if mode == "library" or not is_dw3x3(conv, stride, padding, groups) \
            or x.shape[-1] != conv.out_channels:
        return None
    if stride == 1:
        if dwconv.supports_fused(x.shape):
            return dwconv.dw_conv3x3_fused if mode == "fused" else dwconv.dw_conv3x3_wg
    elif mode == "fused" and dwconv.supports_fused_s2(x.shape):
        return dwconv.dw_conv3x3s2_fused
    elif mode == "wgrad":           # JAX has no stride-2 wgrad route: not a refusal
        return None
    key = (mode, stride, tuple(x.shape))
    DW_REFUSED[key] = DW_REFUSED.get(key, 0) + 1
    return None


def conv_nchw(conv: nn.Conv2d, x: torch.Tensor, stride: int, padding: int, groups: int,
              dw_kernel: str = "library") -> torch.Tensor:
    """The bias-free conv `conv` on the NHWC map x, in x's dtype, as an NCHW
    view (channels_last strides): the library conv, or a depthwise 3x3
    site's kernel route `dw_kernel` (`dw_route`)."""
    route = dw_route(dw_kernel, conv, stride, padding, groups, x)
    if route is None:
        return F.conv2d(x.permute(0, 3, 1, 2), conv.weight.to(x.dtype), None, stride,
                        padding, 1, groups)
    # the taps in the compute dtype, as the JAX package's _DWConv3x3 hands
    # them over: the weight grad rounds to it too
    w9 = conv.weight.to(x.dtype).reshape(-1, 9).t()
    return route(x.contiguous(), w9).permute(0, 3, 1, 2)


def conv1x1_dot(conv: nn.Conv2d, x: torch.Tensor, stride: int) -> torch.Tensor:
    """A 1x1 groups-1 pad-0 conv on the NHWC map x as the channel product
    x[:, ::s, ::s] @ W (`torch.matmul`), in x's dtype, as an NCHW view
    (channels_last strides): the JAX package's `_Conv1x1Dot`."""
    if stride > 1:
        x = x[:, ::stride, ::stride]
    w = conv.weight.to(x.dtype).reshape(conv.out_channels, conv.in_channels)
    return torch.matmul(x, w.t()).permute(0, 3, 1, 2)


def batch_norm(bn: nn.modules.batchnorm._BatchNorm, y: torch.Tensor, training: bool,
               momentum: float = 0.9) -> torch.Tensor:
    """BatchNorm of y over every dim but dim 1: train mode as
    `batch_norm_train`; eval mode on the running statistics. Where those
    statistics require grad (a `torch.func.functional_call` that
    differentiates through them, as the JAX package's meta step does), eval
    BN is written out as flax computes it, since `F.batch_norm` takes no
    grad there."""
    if training:
        return batch_norm_train(bn, y, momentum)
    if bn.running_mean.requires_grad or bn.running_var.requires_grad:
        shape = (1, -1) + (1,) * (y.ndim - 2)
        scale = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
        return ((y - bn.running_mean.view(shape)) * scale.view(shape)
                + bn.bias.view(shape)).to(y.dtype)
    return F.batch_norm(y, bn.running_mean, bn.running_var, bn.weight, bn.bias, False, 0.0,
                        bn.eps)


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
    The kernels take and return NHWC; BatchNorm runs on the NCHW view.

    Two gates of the JAX package's, off by default and read at each call,
    leave the state_dict as it is: `conv1x1_dot` (None: the module default
    `DEFAULT_CONV1X1_DOT`) runs a 1x1 groups-1 pad-0 conv as a channel
    product (`conv1x1_dot`); `ops.bn.DEFAULT_MXU_BN` runs the train-mode
    BatchNorm through `ops.bn.bn_train_norm` (`mxu_batch_norm_train`)."""

    MOMENTUM = 0.9        # flax's convention: the weight of the old value

    def __init__(self, in_features: int, features: int, kernel_size: int = 1,
                 stride: int = 1, padding: int = 0, groups: int = 1,
                 bn_weight_init: float = 1.0, *, dw_kernel: str = "library",
                 conv1x1_dot: bool | None = None,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        _check_dw_kernel(dw_kernel)
        self.stride, self.padding, self.groups = stride, padding, groups
        self.dtype = dtype
        self.dw_kernel = dw_kernel
        self.conv1x1_dot = conv1x1_dot
        self.c = nn.Conv2d(in_features, features, kernel_size, stride, padding,
                           groups=groups, bias=False, device=device)
        self.bn = nn.BatchNorm2d(features, eps=1e-5, device=device)
        nn.init.constant_(self.bn.weight, bn_weight_init)

    def is_dw3x3(self) -> bool:
        return is_dw3x3(self.c, self.stride, self.padding, self.groups)

    def _dw_route(self, x: torch.Tensor):
        """The kernel route's function for this input, or None for the
        library conv."""
        return dw_route(self.dw_kernel, self.c, self.stride, self.padding, self.groups, x)

    def is_1x1(self) -> bool:
        """A 1x1 groups-1 pad-0 conv: the `conv1x1_dot` route's sites."""
        return self.c.kernel_size == (1, 1) and self.groups == 1 and self.padding == 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        use_dot = DEFAULT_CONV1X1_DOT if self.conv1x1_dot is None else self.conv1x1_dot
        if use_dot and self.is_1x1():
            y = conv1x1_dot(self.c, x, self.stride)
        else:
            y = conv_nchw(self.c, x, self.stride, self.padding, self.groups, self.dw_kernel)
        if self.training and bn_ops.DEFAULT_MXU_BN:
            y = mxu_batch_norm_train(self.bn, y, self.MOMENTUM)
        else:
            y = batch_norm(self.bn, y, self.training, self.MOMENTUM)
        return y.permute(0, 2, 3, 1)


def set_dw_kernel(model: nn.Module, mode: str) -> None:
    """Route every module of `model` that has a `dw_kernel` (a ConvBN,
    Cream's blocks) through `mode` (see `ConvBN`): the counterpart of setting
    the JAX package's `DEFAULT_DW_VJP`. Only the depthwise 3x3 sites change
    behaviour."""
    _check_dw_kernel(mode)
    for m in model.modules():
        if hasattr(m, "dw_kernel"):
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
