"""Attention with a trained per-offset bias table (LeViT/TinyViT style).

Counterparts of `cream_tpu/nn/attention.py`'s `BiasAttention` (over the N
tokens of a (B, N, C) sequence) and `WindowBiasAttention` (per
non-overlapping window of an NHWC map): pre-LN, fused qkv projection (q/k
get key_dim, v gets attn_ratio*key_dim, packed per head), a learned
(num_heads, num_offsets) bias table gathered through a static (N, N) index
map, softmax, value product, output projection. Parameter names are the
released TinyViT `Attention`'s (`norm`, `qkv`, `proj`, `attention_biases`).
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from cream_tpu_torch.nn.layers import layer_norm, linear
from cream_tpu_torch.ops import bias_attention, window_relayout
from cream_tpu_torch.ops.common import attention_bias_indices
from cream_tpu_torch.ops.window import window_partition, window_reverse
from cream_tpu_torch.ops.window_attention import (MAX_TOKENS, attend,
                                                  fused_window_attention,
                                                  split_qkv,
                                                  window_attention_ref)


def fits_kernel(H: int, W: int, window: int) -> bool:
    """The kernel path's shape rule: whole windows, at most 256 tokens each."""
    return H % window == 0 and W % window == 0 and window * window <= MAX_TOKENS


class WindowBiasAttention(nn.Module):
    """Bias-attention over (window x window) tiles of a (B, H, W, C) map.

    Whole windows (H and W multiples of the window, N <= 256): LN and the
    qkv GEMM run on the whole map, and the qkv bias, the windowing and the
    attention run in one op — `fused_window_attention`, whose CUDA kernel
    never transposes in memory. `use_kernel=False` swaps that op for its
    plain version `window_attention_ref`, so the two paths differ only in
    the attention. Ragged windows (the plain path): the reference order —
    zero-pad and partition first, then LN inside the windows, so padded
    tokens pass through LN and act as keys. Both orders give the same result
    on whole windows.

    Training takes the same paths: on the card the op is the autograd
    Function `FusedWindowAttention` (K1 forward, K2 backward), the grad of
    `attention_biases` flows back through the `[:, idxs]` gather, and
    `use_kernel=False` trains through autograd of the plain forward.
    """

    def __init__(self, dim: int, key_dim: int, num_heads: int, window: int,
                 attn_ratio: float = 1.0, use_kernel: bool = True, *,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.heads, self.kd = num_heads, key_dim
        self.dv = int(attn_ratio * key_dim)
        self.window = window
        self.use_kernel = use_kernel
        self.dtype = dtype
        idxs, num_offsets = attention_bias_indices((window, window))
        self.norm = nn.LayerNorm(dim, eps=1e-5, device=device)
        self.qkv = nn.Linear(dim, num_heads * (2 * key_dim + self.dv),
                             device=device)
        self.proj = nn.Linear(num_heads * self.dv, dim, device=device)
        self.attention_biases = nn.Parameter(
            torch.zeros(num_heads, num_offsets, device=device))
        self.register_buffer("attention_bias_idxs",
                             torch.as_tensor(idxs, dtype=torch.long,
                                             device=device),
                             persistent=False)

    def kernel_path(self, x: torch.Tensor) -> bool:
        """Whether `forward(x)` runs the fused kernel."""
        _, H, W, _ = x.shape
        return self.use_kernel and x.is_cuda and fits_kernel(H, W, self.window)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, H, W, _ = x.shape
        if H < self.window or W < self.window:
            raise ValueError(f"map {H}x{W} is smaller than window {self.window}")
        x = x.to(self.dtype)
        bias = self.attention_biases[:, self.attention_bias_idxs]   # (h, N, N)
        if fits_kernel(H, W, self.window):
            out = self.forward_fused(x, bias)
        else:
            out = self.forward_windowed(x, bias)
        return linear(self.proj, out, self.dtype)

    def forward_fused(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        """LN and qkv GEMM on the map; qkv bias, windows and attention in the
        attention op (the kernel on the card unless `use_kernel` is off).
        Returns (B, H, W, heads*dv) before the output projection."""
        y = layer_norm(self.norm, x, self.dtype)
        qkv = F.linear(y, self.qkv.weight.to(self.dtype))
        attention = (fused_window_attention if self.kernel_path(x)
                     else window_attention_ref)
        return attention(qkv, bias, window=self.window, heads=self.heads,
                         kd=self.kd, dv=self.dv, qkv_bias=self.qkv.bias)

    def relayout_path(self, x: torch.Tensor) -> bool:
        """Whether `forward_windowed(x)` partitions and reverses through the
        window relayout kernels (K10): whole windows, on the card, in eval
        and outside autograd (K10 has no backward, as in JAX)."""
        _, H, W, _ = x.shape
        return (self.use_kernel and x.is_cuda and not self.training
                and not torch.is_grad_enabled()
                and H % self.window == 0 and W % self.window == 0)

    def forward_windowed(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        """Partition (zero-padded), LN and qkv inside the windows, plain
        attention, reverse. Returns (B, H, W, heads*dv). On `relayout_path`
        the partition and the reverse are K10's copies; ragged maps take the
        zero-padded plain partition.

        The qkv bias is added after the GEMM's output is rounded to the
        compute dtype, as the JAX package's Dense and the fused op do."""
        _, H, W, _ = x.shape
        relayout = self.relayout_path(x)
        if relayout:
            w = window_relayout.window_partition_kernel(x, self.window)
            padded = (H, W)
        else:
            w, padded = window_partition(x, self.window)
        w = F.linear(layer_norm(self.norm, w, self.dtype),
                     self.qkv.weight.to(self.dtype)) + self.qkv.bias.to(self.dtype)
        q, k, v = split_qkv(w, "head_major", self.heads, self.kd, self.dv)
        o = attend(q, k, v, bias)
        if relayout:
            return window_relayout.window_reverse_kernel(o, self.window, (H, W))
        return window_reverse(o, self.window, padded, (H, W))


class BiasAttention(nn.Module):
    """Bias-attention over the N = resolution[0]*resolution[1] tokens of a
    (B, N, dim) input: the released TinyViT `Attention` and the JAX
    package's `BiasAttention`. v gets attn_ratio*key_dim channels per head.

    `use_kernel` (the JAX `use_pallas`, on by default): in eval and outside
    autograd, on CUDA tensors and where K3 takes the shape
    (`ops.bias_attention.supports_shape`), softmax and the two products run
    in `fused_bias_attention` (K3). Otherwise the plain route mirrors the
    JAX module's einsum path: fp32 scores, + bias, softmax cast to the
    compute dtype, P·V in the compute dtype."""

    def __init__(self, dim: int, key_dim: int, num_heads: int,
                 attn_ratio: float = 4.0, resolution: tuple[int, int] = (7, 7),
                 use_kernel: bool = True, *, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.heads, self.kd = num_heads, key_dim
        self.dv = int(attn_ratio * key_dim)
        self.use_kernel = use_kernel
        self.dtype = dtype
        idxs, num_offsets = attention_bias_indices(tuple(resolution))
        self.norm = nn.LayerNorm(dim, eps=1e-5, device=device)
        self.qkv = nn.Linear(dim, num_heads * (2 * key_dim + self.dv), device=device)
        self.proj = nn.Linear(num_heads * self.dv, dim, device=device)
        self.attention_biases = nn.Parameter(
            torch.zeros(num_heads, num_offsets, device=device))
        self.register_buffer("attention_bias_idxs",
                             torch.as_tensor(idxs, dtype=torch.long, device=device),
                             persistent=False)

    def kernel_path(self, x: torch.Tensor) -> bool:
        """Whether `forward(x)` runs K3."""
        return (self.use_kernel and x.is_cuda and not self.training
                and not torch.is_grad_enabled()
                and bias_attention.supports_shape(x.shape[1], self.kd, self.dv))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, _ = x.shape
        if N != self.attention_bias_idxs.shape[0]:
            raise ValueError(f"tokens {N} != {self.attention_bias_idxs.shape[0]} "
                             f"of the resolution")
        x = layer_norm(self.norm, x.to(self.dtype), self.dtype)
        # the bias added to the GEMM's rounded output, as flax's Dense does
        qkv = F.linear(x, self.qkv.weight.to(self.dtype)) + self.qkv.bias.to(self.dtype)
        q, k, v = split_qkv(qkv, "head_major", self.heads, self.kd, self.dv)
        bias = self.attention_biases[:, self.attention_bias_idxs]   # (h, N, N)
        if self.kernel_path(x):
            out = bias_attention.fused_bias_attention(
                *(t.transpose(1, 2).contiguous() for t in (q, k, v)), bias)
            out = out.transpose(1, 2)                                # (B, N, h, dv)
        else:
            s = torch.einsum("bnhk,bmhk->bhnm", q.float(), k.float()) * self.kd ** -0.5
            p = torch.softmax(s + bias.float()[None], dim=-1).to(self.dtype)
            out = torch.einsum("bhnm,bmhd->bnhd", p, v)
        return linear(self.proj, out.reshape(B, N, self.heads * self.dv), self.dtype)
