"""Shared Swin-lineage primitives: relative-position-bias window attention,
shifted-window masking, patch embedding and merging.

Counterpart of `cream_tpu/nn/swin.py` (the Swin blocks of AutoFormerV2's
SSS.py and MiniViT's Mini-Swin). The relative position index and the
shifted-window mask depend only on static shapes: both are host-side numpy
constants, and the mask's tensor is made once per (shape, device) and kept,
so a forward copies nothing from the host.

NHWC feature maps throughout. Parameter names are the released
microsoft/Cream Swin/S3 names (`qkv`, `proj`,
`relative_position_bias_table`; `patch_embed.proj`, `downsample.reduction`),
so released state_dicts load as they are once `zoo.load.load_pth` has
dropped their index and mask buffers.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from cream_tpu_torch.nn.attention import fits_kernel
from cream_tpu_torch.nn.layers import layer_norm, linear
from cream_tpu_torch.ops.window import window_partition, window_reverse
from cream_tpu_torch.ops.window_attention import (HEAD_DIMS,
                                                  fused_window_attention,
                                                  split_qkv,
                                                  window_attention_ref)


@functools.lru_cache(maxsize=None)
def relative_position_index(wh: int, ww: int) -> np.ndarray:
    """(N, N) index into a (2wh-1)*(2ww-1) bias table (SSS.py:84-96)."""
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww),
                                  indexing="ij"))           # 2, wh, ww
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]               # 2, N, N
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    return rel.sum(-1).astype(np.int32)


@functools.lru_cache(maxsize=None)
def shifted_window_mask(H: int, W: int, window: int, shift: int) -> np.ndarray:
    """(nW, N, N) additive mask of an (H, W) map already padded to window
    multiples: 0 within a region, -100 across regions (SSS.py:201-221)."""
    img = np.zeros((H, W), np.int32)
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    nH, nW_ = H // window, W // window
    wins = img.reshape(nH, window, nW_, window).transpose(0, 2, 1, 3)
    wins = wins.reshape(-1, window * window)
    mask = wins[:, None, :] - wins[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def shifted_window_mask_tensor(H: int, W: int, window: int, shift: int,
                               device: torch.device) -> torch.Tensor:
    """`shifted_window_mask` as an fp32 tensor on `device`, made once per
    key. It is made outside inference mode, so a mask first made under
    `torch.inference_mode` can still be saved for a backward later."""
    with torch.inference_mode(False):
        return torch.tensor(shifted_window_mask(H, W, window, shift),
                            device=device)


class SwinWindowAttention(nn.Module):
    """Window MHSA with a learned relative-position bias table, on a
    (B, Hp, Wp, C) map whose sides are window multiples.

    `head_dim=None` gives dim // num_heads (Swin, Mini-Swin); S3 fixes it at
    32 (SSS.py:79). qkv lanes are packed [q all heads | k | v] ("qkv_major").

    Without `proj_l`/`proj_w`: the qkv GEMM runs on the map without its
    bias, and the bias fold, the windows and the attention run in one op.
    On the kernel path (`use_kernel`, a CUDA map, whole windows of at most
    256 tokens, a head dim the kernels are built for) that op is
    `fused_window_attention` (K1 forward, K2 backward through
    `FusedWindowAttention`); otherwise its plain version
    `window_attention_ref`. Both scale the fp32 scores, not q.

    With MiniViT's head transforms `proj_l`/`proj_w` (callables on the
    (..., heads) axis), or with `capture` (a list that gets the qkv states,
    as the JAX package's `sow_qkv`): the JAX package's plain route, which it
    takes for them on every device — q scaled in the compute dtype, fp32
    scores plus the bias, `proj_l`, the mask, softmax, `proj_w`, P in the
    compute dtype, P.V."""

    def __init__(self, dim: int, window: int, num_heads: int,
                 head_dim: int | None = None, use_kernel: bool = True, *,
                 dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.heads, self.window = num_heads, window
        self.head_dim = head_dim if head_dim is not None else dim // num_heads
        self.use_kernel = use_kernel
        self.dtype = dtype
        inner = num_heads * self.head_dim
        self.qkv = nn.Linear(dim, 3 * inner, device=device)
        self.proj = nn.Linear(inner, dim, device=device)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, num_heads, device=device))
        nn.init.trunc_normal_(self.relative_position_bias_table, std=0.02)
        self.register_buffer(
            "relative_position_index",
            torch.as_tensor(relative_position_index(window, window),
                            dtype=torch.long, device=device),
            persistent=False)

    def kernel_path(self, x: torch.Tensor) -> bool:
        """Whether `forward(x)` without head transforms runs the kernels."""
        _, Hp, Wp, _ = x.shape
        return (self.use_kernel and x.is_cuda and fits_kernel(Hp, Wp, self.window)
                and self.head_dim in HEAD_DIMS)

    def bias(self) -> torch.Tensor:
        """The (heads, N, N) fp32 bias gathered from the table."""
        N = self.window * self.window
        idx = self.relative_position_index.view(-1)
        return self.relative_position_bias_table[idx].view(N, N, -1).permute(2, 0, 1)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None,
                proj_l=None, proj_w=None, capture: list | None = None) -> torch.Tensor:
        _, Hp, Wp, _ = x.shape
        if Hp % self.window or Wp % self.window:
            raise ValueError(f"map {Hp}x{Wp} is not a multiple of window {self.window}")
        x = x.to(self.dtype)
        if proj_l is None and proj_w is None and capture is None:
            qkv = F.linear(x, self.qkv.weight.to(self.dtype))
            attention = (fused_window_attention if self.kernel_path(x)
                         else window_attention_ref)
            out = attention(qkv, self.bias(), mask, window=self.window,
                            heads=self.heads, kd=self.head_dim, dv=self.head_dim,
                            layout="qkv_major", qkv_bias=self.qkv.bias)
        else:
            out = self.forward_transformed(x, mask, proj_l, proj_w, capture)
        return linear(self.proj, out, self.dtype)

    def forward_transformed(self, x: torch.Tensor, mask: torch.Tensor | None,
                            proj_l, proj_w, capture: list | None = None) -> torch.Tensor:
        """The plain route with head transforms (`cream_tpu/nn/swin.py:
        125-158`); `capture` gets the qkv states (3, Bn, heads, N, d).
        Returns (B, Hp, Wp, heads*head_dim)."""
        _, Hp, Wp, _ = x.shape
        h, d, N, dt = self.heads, self.head_dim, self.window ** 2, self.dtype
        w = window_partition(x, self.window)[0]                      # (Bn, N, C)
        # the bias added to the GEMM's rounded output, as flax's Dense does
        qkv = F.linear(w, self.qkv.weight.to(dt)) + self.qkv.bias.to(dt)
        if capture is not None:
            capture.append(qkv.view(w.shape[0], N, 3, h, d).permute(2, 0, 3, 1, 4))
        q, k, v = split_qkv(qkv, "qkv_major", h, d, d)
        q = q * d ** -0.5                                            # in dt
        s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float())
        s = s + self.bias()[None]
        if proj_l is not None:
            s = proj_l(s.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        if mask is not None:
            nW = mask.shape[0]
            s = (s.view(-1, nW, h, N, N) + mask[None, :, None].to(s.dtype)).view(-1, h, N, N)
        p = torch.softmax(s, dim=-1)
        if proj_w is not None:
            p = proj_w(p.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        o = torch.einsum("bhnm,bmhd->bnhd", p.to(dt).float(), v.float()).to(dt)
        return window_reverse(o.reshape(-1, N, h * d), self.window, (Hp, Wp), (Hp, Wp))


def swin_attend(x: torch.Tensor, attn: SwinWindowAttention, window: int,
                shift: int, proj_l=None, proj_w=None,
                capture: list | None = None) -> torch.Tensor:
    """Roll, window-attend, unroll: one (shifted) window attention pass over
    a (B, H, W, C) map.

    The window is min(window, H, W), and the shift 0 when the window covers
    the map. The map is zero-padded to window multiples *before* the roll,
    so the mask is that of the padded grid (the reference pads first, then
    rolls)."""
    _, H, W, _ = x.shape
    window = min(window, H, W)
    shift = 0 if window >= min(H, W) else shift
    if window != attn.window:
        raise ValueError(f"window {window} at {H}x{W}, the attention was built "
                         f"for {attn.window}")
    Hp, Wp = -(-H // window) * window, -(-W // window) * window
    if (Hp, Wp) != (H, W):
        x = F.pad(x, (0, 0, 0, Wp - W, 0, Hp - H))
    mask = None
    if shift > 0:
        x = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))
        mask = shifted_window_mask_tensor(Hp, Wp, window, shift, x.device)
    x = attn(x, mask, proj_l, proj_w, capture)
    if shift > 0:
        x = torch.roll(x, shifts=(shift, shift), dims=(1, 2))
    if (Hp, Wp) != (H, W):
        x = x[:, :H, :W]
    return x


class SwinPatchMerging(nn.Module):
    """Concat 2x2 neighbours -> LN -> Linear(4C -> out_dim), no bias
    (SSS.py:284-322)."""

    def __init__(self, dim: int, out_dim: int, *, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.norm = nn.LayerNorm(4 * dim, eps=1e-5, device=device)
        self.reduction = nn.Linear(4 * dim, out_dim, bias=False, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        x = x.reshape(B, H // 2, 2, W // 2, 2, C)
        # order [x0;x1;x2;x3] = [(0,0),(1,0),(0,1),(1,1)] (SSS.py:311-314)
        x = torch.cat([x[:, :, 0, :, 0], x[:, :, 1, :, 0],
                       x[:, :, 0, :, 1], x[:, :, 1, :, 1]], dim=-1)
        return linear(self.reduction, layer_norm(self.norm, x, self.dtype), self.dtype)


class SwinPatchEmbed(nn.Module):
    """4x4 stride-4 conv patchify with bias, then LN; NHWC in and out."""

    def __init__(self, in_chans: int, embed_dim: int, patch_size: int = 4, *,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, patch_size,
                              device=device)
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x.to(self.dtype).permute(0, 3, 1, 2),
                     self.proj.weight.to(self.dtype), self.proj.bias.to(self.dtype),
                     self.proj.stride)
        return layer_norm(self.norm, y.permute(0, 2, 3, 1), self.dtype)
