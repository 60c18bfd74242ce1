"""EfficientViT — throughput-optimized 3-stage pyramid with cascaded group
attention, eval.

Counterpart of `cream_tpu/models/efficientvit.py` (M0–M5). Everything is
Conv+BN, NHWC:
  patch_embed: four stride-2 Conv3x3+BN with ReLU between (16x reduction)
  stage: EfficientViTBlocks; between stages a sandwich of (dw-conv residual +
         FFN residual) -> PatchMerging(SE) -> (dw-conv residual + FFN residual)
  EfficientViTBlock: dw-conv residual, FFN residual, window cascaded group
         attention residual, dw-conv residual, FFN residual
  head: BatchNorm1d + Linear on the mean-pooled map (a distillation head
        beside it in eval averages the two)

Module and parameter names are those of the released microsoft/Cream
EfficientViT (`patch_embed.{0,2,4,6}`, `blocks{1,2,3}.{i}.dw0.m.c.weight`,
`...mixer.m.attn.qkvs.{h}`, `.dws.{h}`, `.proj.1`, `.attention_biases`,
`blocks{2,3}.1.se.conv_reduce`, `head.bn`, `head.l`), so released
state_dicts load as they are (`zoo.load.load_pth`) and the JAX package's
`convert_efficientvit` maps a port state_dict to its variables.

The window of each stage is min(window_size, stage resolution, map size),
which follows from `img_size`; a model takes only inputs of that size.
Train mode is not ported and raises.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from cream_tpu_torch.models.registry import register_model
from cream_tpu_torch.nn.layers import BNLinear, ConvBN
from cream_tpu_torch.ops.cga import fold_cga_variables, fused_cga
from cream_tpu_torch.ops.cga_core import cga_attention
from cream_tpu_torch.ops.common import attention_bias_indices
from cream_tpu_torch.ops.window import window_partition, window_reverse

ATTN_KERNELS = ("cascade", "core", "plain")


def _conv_s2_out(n: int) -> int:
    """Spatial size after a 3x3, stride-2, pad-1 conv."""
    return (n - 1) // 2 + 1


class Residual(nn.Module):
    """x + m(x) (the released `Residual`; its drop path is train-only)."""

    def __init__(self, m: nn.Module):
        super().__init__()
        self.m = m

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.m(x)


class SqueezeExcite(nn.Module):
    """timm-style SE on an NHWC map: pool -> 1x1 reduce -> ReLU -> 1x1 expand
    -> sigmoid gate (released names `conv_reduce`, `conv_expand`)."""

    def __init__(self, channels: int, rd_ratio: float = 0.25, *, dtype, device):
        super().__init__()
        self.dtype = dtype
        rd = max(1, round(channels * rd_ratio))
        self.conv_reduce = nn.Conv2d(channels, rd, 1, device=device)
        self.conv_expand = nn.Conv2d(rd, channels, 1, device=device)

    def _conv1x1(self, conv: nn.Conv2d, s: torch.Tensor) -> torch.Tensor:
        return F.linear(s, conv.weight.flatten(1).to(self.dtype), conv.bias.to(self.dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(1, 2), keepdim=True)
        s = torch.relu(self._conv1x1(self.conv_reduce, s))
        return x * torch.sigmoid(self._conv1x1(self.conv_expand, s))


class FFN(nn.Module):
    """1x1 ConvBN -> ReLU -> 1x1 ConvBN (bn gamma init 0)."""

    def __init__(self, dim: int, hidden: int, *, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.pw1 = ConvBN(dim, hidden, 1, **kw)
        self.pw2 = ConvBN(hidden, dim, 1, bn_weight_init=0.0, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pw2(torch.relu(self.pw1(x)))


class PatchMerging(nn.Module):
    """1x1 expand(4x) -> 3x3 dw stride-2 -> SE -> 1x1 project, ReLU between."""

    def __init__(self, dim: int, out_dim: int, *, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        hid = int(dim * 4)
        self.conv1 = ConvBN(dim, hid, 1, **kw)
        self.conv2 = ConvBN(hid, hid, 3, 2, 1, groups=hid, **kw)
        self.se = SqueezeExcite(hid, 0.25, **kw)
        self.conv3 = ConvBN(hid, out_dim, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.conv1(x))
        x = torch.relu(self.conv2(x))
        return self.conv3(self.se(x))


class CascadedGroupAttention(nn.Module):
    """Per-head chunked input with cascaded feature refinement and bias tables,
    on (B, ws, ws, C) windows.

    `attn_kernel` picks the route (eval only; all three compute the same
    function, each with its own rounding points):
      "cascade" (default): the whole cascade as one `fused_cga` op on the
          BN-folded weights: one K4 launch per call on the card,
          `fused_cga_ref` on the CPU. The fold is cached per module and
          recomputed whenever a parameter or buffer changes (its version
          counter or storage), so `load_state_dict` or `.to()` never leave a
          stale fold.
      "core": the qkv and depthwise ConvBNs as library ops, the attention of
          each head as `cga_attention`: one K5 launch per head on the card.
      "plain": the JAX package's XLA math — scores rounded to the compute
          dtype, exp of (s − rowmax) in fp32 rounded, the row sum carried by
          a ones-column through the P·V product and the division after it.
    """

    def __init__(self, dim: int, key_dim: int, num_heads: int, attn_ratio: float,
                 resolution: int, kernels: Sequence[int], attn_kernel: str = "cascade",
                 *, dtype, device):
        super().__init__()
        if attn_kernel not in ATTN_KERNELS:
            raise ValueError(f"attn_kernel must be one of {ATTN_KERNELS}, got {attn_kernel!r}")
        self.attn_kernel = attn_kernel
        self.dtype = dtype
        self.heads, self.kd = num_heads, key_dim
        self.d = int(attn_ratio * key_dim)
        self.c_in = dim // num_heads
        self.resolution = resolution
        self.ks_max = max(kernels[:num_heads])
        kw = dict(dtype=dtype, device=device)
        self.qkvs = nn.ModuleList(ConvBN(self.c_in, 2 * key_dim + self.d, 1, **kw)
                                  for _ in range(num_heads))
        self.dws = nn.ModuleList(ConvBN(key_dim, key_dim, kernels[i], 1, kernels[i] // 2,
                                        groups=key_dim, **kw)
                                 for i in range(num_heads))
        self.proj = nn.Sequential(nn.ReLU(), ConvBN(self.d * num_heads, dim, 1,
                                                 bn_weight_init=0.0, **kw))
        idxs, n_off = attention_bias_indices((resolution, resolution))
        self.attention_biases = nn.Parameter(torch.zeros(num_heads, n_off, device=device))
        self.register_buffer("attention_bias_idxs",
                             torch.as_tensor(idxs, dtype=torch.long, device=device),
                             persistent=False)
        self._fold_key, self._fold = None, None

    def folded(self) -> tuple[torch.Tensor, ...]:
        """`fold_cga_variables(self, self.dtype)`, cached until a parameter
        or buffer changes."""
        key = (self.dtype, tuple((t.data_ptr(), t._version)
                                 for t in (*self.parameters(), *self.buffers())))
        if key != self._fold_key:
            # plain tensors, not inference tensors, whatever mode the caller is in
            with torch.inference_mode(False), torch.no_grad():
                self._fold = fold_cga_variables(self, self.dtype)
            self._fold_key = key
        return self._fold

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError("EfficientViT training is not ported")
        B, H, W, C = x.shape
        if H != self.resolution or W != self.resolution:
            raise ValueError(f"windows must be {self.resolution}x{self.resolution}, "
                             f"got {H}x{W}")
        x = x.to(self.dtype)
        h, kd, d = self.heads, self.kd, self.d
        if self.attn_kernel == "cascade":
            return fused_cga(x.contiguous(), self.attention_biases, self.attention_bias_idxs,
                             *self.folded(), ws=H, heads=h, c_in=self.c_in, kd=kd,
                             d=d, ks_max=self.ks_max)
        N, scale = H * W, kd ** -0.5
        bias = self.attention_biases[:, self.attention_bias_idxs]   # (h, N, N) fp32
        chunks = x.split(self.c_in, dim=-1)
        feat, outs = chunks[0], []
        for i in range(h):
            if i > 0:
                feat = feat + chunks[i]
            q, k, v = self.qkvs[i](feat).split([kd, kd, d], dim=-1)
            q = self.dws[i](q).reshape(B, N, kd)
            k, v = k.reshape(B, N, kd), v.reshape(B, N, d)
            if self.attn_kernel == "core":
                o = cga_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                  bias[i], scale)
            else:
                s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale + bias[i]
                s = s.to(self.dtype)
                p = torch.exp((s - s.amax(dim=-1, keepdim=True)).float()).to(self.dtype)
                v1 = torch.cat([v, v.new_ones(B, N, 1)], dim=-1)
                o = torch.matmul(p.float(), v1.float())
                o = (o[..., :d] / o[..., d:]).to(self.dtype)
            feat = o.reshape(B, H, W, d)
            outs.append(feat)
        return self.proj(torch.cat(outs, dim=-1))


class LocalWindowAttention(nn.Module):
    """CascadedGroupAttention over (ws x ws) windows of the map (zero-padded
    to a multiple of ws), or over the whole map when it fits one window."""

    def __init__(self, dim: int, key_dim: int, num_heads: int, attn_ratio: float,
                 window: int, kernels: Sequence[int], attn_kernel: str, *, dtype, device):
        super().__init__()
        self.window = window
        self.attn = CascadedGroupAttention(dim, key_dim, num_heads, attn_ratio, window,
                                           kernels, attn_kernel, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, H, W, C = x.shape
        ws = self.window
        if H <= ws and W <= ws:
            return self.attn(x)
        wx, padded = window_partition(x, ws)
        n_win = wx.shape[0]
        wx = self.attn(wx.reshape(n_win, ws, ws, C))
        return window_reverse(wx.reshape(n_win, ws * ws, C), ws, padded, (H, W))


class EfficientViTBlock(nn.Module):
    def __init__(self, dim: int, key_dim: int, num_heads: int, attn_ratio: float,
                 window: int, kernels: Sequence[int], attn_kernel: str, *, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.dw0 = Residual(ConvBN(dim, dim, 3, 1, 1, groups=dim, bn_weight_init=0.0, **kw))
        self.ffn0 = Residual(FFN(dim, int(dim * 2), **kw))
        self.mixer = Residual(LocalWindowAttention(dim, key_dim, num_heads, attn_ratio,
                                                   window, kernels, attn_kernel, **kw))
        self.dw1 = Residual(ConvBN(dim, dim, 3, 1, 1, groups=dim, bn_weight_init=0.0, **kw))
        self.ffn1 = Residual(FFN(dim, int(dim * 2), **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ffn1(self.dw1(self.mixer(self.ffn0(self.dw0(x)))))


def subsample(dim: int, out_dim: int, *, dtype, device) -> list[nn.Module]:
    """The downsample sandwich between stages, as the three released
    entries at the head of the next stage's Sequential: (dw-conv + FFN
    residuals at the old width), PatchMerging, (dw-conv + FFN residuals at
    the new width). The JAX package's `Subsample`."""
    kw = dict(dtype=dtype, device=device)

    def sandwich(c):
        return nn.Sequential(Residual(ConvBN(c, c, 3, 1, 1, groups=c, **kw)),
                             Residual(FFN(c, int(c * 2), **kw)))
    return [sandwich(dim), PatchMerging(dim, out_dim, **kw), sandwich(out_dim)]


class EfficientViT(nn.Module):
    """Input (B, img_size, img_size, 3) NHWC -> (B, num_classes) logits in
    `dtype` (the pooled features if num_classes is 0)."""

    # ~45 residual branches add to an unnormalised stream: seeded weights
    # shrink the scales of the branches' last BNs (those initialised at 0)
    # so the stream stays O(1) and the attention's softmax does not saturate
    # (`zoo.load.seeded_state_dict`)
    SEEDED_BRANCH_SCALE = 0.2
    SEEDED_BRANCH_ENDS = (".dw0.m.bn.weight", ".dw1.m.bn.weight", ".pw2.bn.weight",
                          ".proj.1.bn.weight")

    def __init__(self, img_size: int = 224, num_classes: int = 1000,
                 patch_size: int = 16, embed_dim: Sequence[int] = (64, 128, 192),
                 key_dim: Sequence[int] = (16, 16, 16), depth: Sequence[int] = (1, 2, 3),
                 num_heads: Sequence[int] = (4, 4, 4), window_size: Sequence[int] = (7, 7, 7),
                 kernels: Sequence[int] = (5, 5, 5, 5), distillation: bool = False,
                 attn_kernel: str = "cascade", *, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.img_size, self.num_classes, self.dtype = img_size, num_classes, dtype
        self.distillation = distillation
        kw = dict(dtype=dtype, device=device)
        ed = embed_dim
        self.patch_embed = nn.Sequential(
            ConvBN(3, ed[0] // 8, 3, 2, 1, **kw), nn.ReLU(),
            ConvBN(ed[0] // 8, ed[0] // 4, 3, 2, 1, **kw), nn.ReLU(),
            ConvBN(ed[0] // 4, ed[0] // 2, 3, 2, 1, **kw), nn.ReLU(),
            ConvBN(ed[0] // 2, ed[0], 3, 2, 1, **kw))
        resolution = img_size // patch_size
        hw = img_size
        for _ in range(4):
            hw = _conv_s2_out(hw)
        stages: list[list[nn.Module]] = [[], [], []]
        for i in range(len(ed)):
            ar = ed[i] / (key_dim[i] * num_heads[i])
            window = min(window_size[i], resolution, hw)
            stages[i] += [EfficientViTBlock(ed[i], key_dim[i], num_heads[i], ar, window,
                                            kernels, attn_kernel, **kw)
                          for _ in range(depth[i])]
            if i < len(ed) - 1:
                stages[i + 1] += subsample(ed[i], ed[i + 1], **kw)
                resolution = _conv_s2_out(resolution)
                hw = _conv_s2_out(hw)
        self.blocks1, self.blocks2, self.blocks3 = (nn.Sequential(*s) for s in stages)
        if num_classes > 0:
            self.head = BNLinear(ed[-1], num_classes, **kw)
            if distillation:
                self.head_dist = BNLinear(ed[-1], num_classes, **kw)

    def set_attn_kernel(self, attn_kernel: str) -> None:
        """Switch every CascadedGroupAttention to the route `attn_kernel`."""
        if attn_kernel not in ATTN_KERNELS:
            raise ValueError(f"attn_kernel must be one of {ATTN_KERNELS}, got {attn_kernel!r}")
        for m in self.modules():
            if isinstance(m, CascadedGroupAttention):
                m.attn_kernel = attn_kernel

    def _stages(self, x: torch.Tensor):
        if self.training:
            raise NotImplementedError("EfficientViT training is not ported")
        if tuple(x.shape[1:]) != (self.img_size, self.img_size, 3):
            raise ValueError(f"expected (B, {self.img_size}, {self.img_size}, 3)"
                             f" NHWC input, got {tuple(x.shape)}")
        x = self.patch_embed(x.to(self.dtype))
        for blocks in (self.blocks1, self.blocks2, self.blocks3):
            x = blocks(x)
            yield x

    def forward_features(self, x: torch.Tensor) -> torch.Tensor:
        *_, x = self._stages(x)
        return x

    def forward_pyramid(self, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """Per-stage maps (strides 16/32/64), each taken after the stage's
        blocks and before the next downsample."""
        return tuple(self._stages(x))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.forward_features(x).mean(dim=(1, 2))
        if self.num_classes == 0:
            return x
        if self.distillation:
            return (self.head(x) + self.head_dist(x)) / 2
        return self.head(x)


# M0-M5 configs from EfficientViT/classification/model/build.py:10-68
_CONFIGS = {
    "efficientvit_m0": dict(embed_dim=(64, 128, 192), depth=(1, 2, 3),
                            num_heads=(4, 4, 4), kernels=(5, 5, 5, 5)),
    "efficientvit_m1": dict(embed_dim=(128, 144, 192), depth=(1, 2, 3),
                            num_heads=(2, 3, 3), kernels=(7, 5, 3, 3)),
    "efficientvit_m2": dict(embed_dim=(128, 192, 224), depth=(1, 2, 3),
                            num_heads=(4, 3, 2), kernels=(7, 5, 3, 3)),
    "efficientvit_m3": dict(embed_dim=(128, 240, 320), depth=(1, 2, 3),
                            num_heads=(4, 3, 4), kernels=(5, 5, 5, 5)),
    "efficientvit_m4": dict(embed_dim=(128, 256, 384), depth=(1, 2, 3),
                            num_heads=(4, 4, 4), kernels=(7, 5, 3, 3)),
    "efficientvit_m5": dict(embed_dim=(192, 288, 384), depth=(1, 3, 4),
                            num_heads=(3, 3, 4), kernels=(7, 5, 3, 3)),
}


def _make_factory(name, cfg):
    def factory(num_classes: int = 1000, *, device, dtype=torch.float32, **kw):
        return EfficientViT(num_classes=num_classes, dtype=dtype, device=device,
                            **cfg, **kw)
    factory.__name__ = name
    return factory


for _name, _cfg in _CONFIGS.items():
    register_model(_make_factory(_name, _cfg))
