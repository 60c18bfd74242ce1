"""Conv+BN / BN+Linear folding for inference.

Counterpart of `cream_tpu/ops/fuse.py` (`fold_conv_bn`, `fold_bn_linear`)
and of `cream_tpu/ops/pallas/mbconv.py:fold_convbn`, in the JAX package's
layouts: conv kernels HWIO (kh, kw, I, O), linear kernels (in, out). The
folded operands feed the fused CGA kernel (`ops/cga.py`).
"""
from __future__ import annotations

import torch


def fold_conv_bn(kernel: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                 mean: torch.Tensor, var: torch.Tensor, eps: float = 1e-5
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold y = BN(conv(x, kernel)) into conv(x, k') + b'.

    kernel: (H, W, I, O) HWIO; the BN statistics are per output channel O."""
    scale = gamma / torch.sqrt(var + eps)
    return kernel * scale, beta - mean * scale


def fold_bn_linear(kernel: torch.Tensor, bias: torch.Tensor | None,
                   gamma: torch.Tensor, beta: torch.Tensor,
                   mean: torch.Tensor, var: torch.Tensor, eps: float = 1e-5
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold y = Linear(BN1d(x)) into Linear'(x).

    kernel: (in, out); the BN acts on the input features (the EfficientViT
    classifier head's BN_Linear)."""
    scale = gamma / torch.sqrt(var + eps)
    shift = beta - mean * scale
    extra = shift @ kernel
    return kernel * scale[:, None], extra if bias is None else bias + extra


def fold_convbn(kernel: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                mean: torch.Tensor, var: torch.Tensor, eps: float = 1e-5
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """ConvBN without a conv bias -> (folded kernel, folded bias), all fp32:
    f = scale·rsqrt(var + eps) on the last (output-channel) axis."""
    f = scale.float() * torch.rsqrt(var.float() + eps)
    return kernel.float() * f, bias.float() - mean.float() * f
