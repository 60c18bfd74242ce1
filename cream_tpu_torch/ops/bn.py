"""Train-mode BatchNorm core with a folded backward (gated, off by default).

Counterpart of `cream_tpu/ops/bn.py`. The JAX package added it to move the
backward's two channel sums (sum dy, sum dy*xhat over every row) off the
TPU's vector unit onto its matrix unit, as a ones-row `dot_general`
against the (M, 2C) operand. On the H100 the port takes them as two ATen
column reductions of the (M, C) fp32 operands instead: a column sum of
rows that are contiguous in memory is one bandwidth-bound pass in ATen's
reduce kernel, where a ones-row GEMM has a K of M (~800 K rows at
TinyViT-21M's stage 0, bs256), so cuBLAS would split it over K, and it
first needs the (M, 2C) concatenation written out. The sums are taken in
fp32 either way.

Semantics match flax nn.BatchNorm(use_running_average=False): biased batch
variance in fp32 (JAX's one-pass E[x^2] - mu^2), normalization in fp32 and
the output in the input's dtype. A gate like JAX's: `DEFAULT_MXU_BN`, read
by `nn.layers.ConvBN` at each train-mode call.
"""
from __future__ import annotations

import torch

# Module-level default for ConvBN sites (the JAX package's A/B knob)
DEFAULT_MXU_BN = False


def _moments(x: torch.Tensor, channel_dim: int = -1) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 (mean, biased variance) per channel over every other dim, the
    variance JAX's one-pass E[x^2] - mean^2."""
    xf = x.float()
    dims = [d for d in range(x.ndim) if d != channel_dim % x.ndim]
    mu = xf.mean(dims)
    var = (xf * xf).mean(dims) - mu * mu
    return mu, var


class _BNTrainNorm(torch.autograd.Function):
    """y = x * inv + (bias - mu * inv), inv = rsqrt(var + eps) * scale, on
    x with its channels on the last dim; the backward is the complete
    train-mode BN backward folded into dx, mu and var get zero grads."""

    @staticmethod
    def forward(ctx, x, mu, var, scale, bias, eps):
        inv = torch.rsqrt(var + eps) * scale
        ctx.save_for_backward(x, mu, var, scale)
        ctx.eps = eps
        return (x.float() * inv + (bias - mu * inv)).to(x.dtype)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, mu, var, scale = ctx.saved_tensors
        C = x.shape[-1]
        m = x.numel() // C
        with torch.profiler.record_function("mxu_batch_norm"):
            inv = torch.rsqrt(var + ctx.eps)
            xf = x.reshape(m, C).float()
            dyf = dy.reshape(m, C).float()
            xhat = (xf - mu) * inv
            dbeta = dyf.sum(0)
            dgamma = (dyf * xhat).sum(0)
            # the standard BN backward, the paths through mu and var included
            dx = (scale * inv / m) * (m * dyf - dbeta - xhat * dgamma)
        return (dx.reshape(x.shape).to(x.dtype), torch.zeros_like(mu),
                torch.zeros_like(var), dgamma.to(scale.dtype), dbeta.to(scale.dtype),
                None)


def bn_train_norm(x: torch.Tensor, mu: torch.Tensor, var: torch.Tensor,
                  scale: torch.Tensor, bias: torch.Tensor, eps: float,
                  channel_dim: int = -1) -> torch.Tensor:
    """y = (x - mu) * rsqrt(var + eps) * scale + bias, with mu/var the batch
    moments OF x (the backward assumes exactly that: the complete standard
    BN backward — including the paths through mu/var — is folded into dx,
    and mu/var receive zero grads, so callers MUST pass `_moments(x)` of the
    same x, not detached or running values). `channel_dim`: x's channel
    dim (-1 for NHWC; 1 for an NCHW view with channels_last strides, which
    is computed on its NHWC view without a copy)."""
    if channel_dim % x.ndim != x.ndim - 1:
        return _BNTrainNorm.apply(x.movedim(channel_dim, -1), mu, var, scale, bias,
                                  eps).movedim(-1, channel_dim)
    return _BNTrainNorm.apply(x, mu, var, scale, bias, eps)
