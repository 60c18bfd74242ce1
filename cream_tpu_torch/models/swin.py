"""Swin-lineage models: Swin, S3 (AutoFormerV2) and Mini-Swin (MiniViT).

Counterpart of `cream_tpu/models/swin.py`, eval and train:
  * SwinTransformer: standard Swin, and the S3 executor when heads, windows
    and MLP ratios come per layer (AutoFormerV2/model/SSS.py:333-577 with
    configs/S3-{T,S,B}.yaml); S3 fixes head_dim at 32 (SSS.py:79).
  * MiniSwin: weight multiplexing: each physical block runs its shared
    attention and MLP `share_num` times with alternating shift, per-repeat
    LayerNorms, per-repeat head transforms proj_l/proj_w around the softmax
    and a per-repeat 7x7 depthwise local conv
    (MiniViT/Mini-Swin/models/swin_transformer_minivit.py:200-344), each
    behind MiniViT's switch; `capture_distill` also returns the qkv and
    hidden states MiniViT's distillation reads.

NHWC activations; input (B, img_size, img_size, 3). Each block's window is
min(window, H, W) at its stage's map size, which follows from `img_size`.
Parameter names are the released microsoft/Cream names
(`layers.{s}.blocks.{i}.attn.qkv`, `...norm1_list.{r}`, `...proj_l.{r}`,
`layers.{s}.downsample.reduction`, `norm`, `head`).

On the card the attention of Swin and S3 runs K1 (and K2 in training) at
qkv_major packing with the shifted-window mask; Mini-Swin's head transforms
take the plain route, as in JAX, so it launches no K1. Train mode follows
`module.training`; drop path draws from the generator passed to `forward`.
"""
from __future__ import annotations

from typing import Any, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from cream_tpu_torch.models.registry import register_model
from cream_tpu_torch.models.tinyvit import TinyViTLayer
from cream_tpu_torch.nn.act import gelu
from cream_tpu_torch.nn.layers import layer_norm, linear
from cream_tpu_torch.nn.swin import (SwinPatchEmbed, SwinPatchMerging,
                                     SwinWindowAttention, swin_attend)
from cream_tpu_torch.ops.common import drop_path


class Mlp(nn.Module):
    """fc1 -> GELU -> fc2 (no LayerNorm inside, unlike TinyViT's MlpLN)."""

    def __init__(self, dim: int, hidden: int, out: int, *, dtype, device):
        super().__init__()
        self.dtype = dtype
        self.fc1 = nn.Linear(dim, hidden, device=device)
        self.fc2 = nn.Linear(hidden, out, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(self.fc2, gelu(linear(self.fc1, x, self.dtype)), self.dtype)


class SwinBlock(nn.Module):
    """LN -> (shifted) window attention -> residual; LN -> MLP -> residual.
    The attention is built for min(window, H, W) at `resolution`, so its
    bias table is (2*window-1)**2 rows of the clipped window."""

    def __init__(self, dim: int, num_heads: int, window: int, shift: int,
                 resolution: tuple[int, int], mlp_ratio: float = 4.0,
                 head_dim: int | None = None, drop_path_rate: float = 0.0,
                 use_kernel: bool = True, *, dtype, device):
        super().__init__()
        self.window, self.shift = window, shift
        self.drop_path_rate, self.dtype = drop_path_rate, dtype
        self.norm1 = nn.LayerNorm(dim, eps=1e-5, device=device)
        self.attn = SwinWindowAttention(dim, min(window, *resolution), num_heads,
                                        head_dim, use_kernel=use_kernel,
                                        dtype=dtype, device=device)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        eval_ = not self.training
        h = swin_attend(layer_norm(self.norm1, x, self.dtype), self.attn,
                        self.window, self.shift)
        x = x + drop_path(h, self.drop_path_rate, eval_, generator)
        h = self.mlp(layer_norm(self.norm2, x, self.dtype))
        return x + drop_path(h, self.drop_path_rate, eval_, generator)


def _per_layer(val, stage: int, i: int):
    """A hyper-parameter given as one value, one per stage, or one per layer."""
    if isinstance(val, (int, float)):
        return val
    v = val[stage]
    return v if isinstance(v, (int, float)) else v[i]


class _Pyramid(nn.Module):
    """Patch embed, four stages of blocks with a SwinPatchMerging after each
    but the last, final LN, token mean, head."""

    def __init__(self, img_size: int, num_classes: int, embed_dims: Sequence[int],
                 dtype: torch.dtype, device):
        super().__init__()
        self.img_size, self.num_classes, self.dtype = img_size, num_classes, dtype
        self.patch_embed = SwinPatchEmbed(3, embed_dims[0], dtype=dtype, device=device)
        self.layers = nn.ModuleList()
        self.norm = nn.LayerNorm(embed_dims[-1], eps=1e-5, device=device)
        if num_classes > 0:
            self.head = nn.Linear(embed_dims[-1], num_classes, device=device)

    def _stages(self, embed_dims, depths, make_blocks, dtype, device):
        """Builds `self.layers`; make_blocks(stage, resolution) -> blocks."""
        res = self.img_size // 4
        for s in range(len(depths)):
            down = None
            if s < len(depths) - 1:
                down = SwinPatchMerging(embed_dims[s], embed_dims[s + 1],
                                        dtype=dtype, device=device)
            self.layers.append(TinyViTLayer(make_blocks(s, (res, res)), down))
            res //= 2

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        if tuple(x.shape[1:]) != (self.img_size, self.img_size, 3):
            raise ValueError(f"expected (B, {self.img_size}, {self.img_size}, 3)"
                             f" NHWC input, got {tuple(x.shape)}")
        return self.patch_embed(x)

    def pool_head(self, x: torch.Tensor) -> torch.Tensor:
        x = layer_norm(self.norm, x, self.dtype).mean(dim=(1, 2))
        if self.num_classes > 0:
            x = linear(self.head, x, self.dtype)
        return x

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """Logits of NHWC images. In train mode with drop path on,
        `generator` supplies its draws (required then)."""
        x = self.embed(x)
        for layer in self.layers:
            x = layer(x, generator)
        return self.pool_head(x)


class SwinTransformer(_Pyramid):
    """Standard Swin; the S3 executor when per-layer lists are given.
    Block (s, i) shifts by window//2 when i is odd; drop path grows
    linearly from 0 to `drop_path_rate` over all blocks."""

    def __init__(self, img_size: int = 224, num_classes: int = 1000,
                 embed_dims: Sequence[int] = (96, 192, 384, 768),
                 depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Any = (3, 6, 12, 24), window_sizes: Any = 7,
                 mlp_ratios: Any = 4.0, head_dim: int | None = None,
                 drop_path_rate: float = 0.1, use_kernel: bool = True, *,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__(img_size, num_classes, embed_dims, dtype, device)
        total = sum(depths)
        dpr = [drop_path_rate * i / max(total - 1, 1) for i in range(total)]

        def blocks(s, res):
            out = []
            for i in range(depths[s]):
                ws = int(_per_layer(window_sizes, s, i))
                out.append(SwinBlock(
                    embed_dims[s], int(_per_layer(num_heads, s, i)), ws,
                    0 if i % 2 == 0 else ws // 2, res,
                    float(_per_layer(mlp_ratios, s, i)), head_dim,
                    dpr[sum(depths[:s]) + i], use_kernel, dtype=dtype, device=device))
            return out
        self._stages(embed_dims, depths, blocks, dtype, device)


class MiniSwinBlock(nn.Module):
    """One physical block executed `share_num` times with shared attn/MLP.
    Each repeat has its own norm1/norm2 (`is_sep_layernorm`; else one
    `norm1`/`norm2` for all), proj_l/proj_w head transforms
    (`is_transform_heads`) and local LN + 7x7 depthwise conv
    (`is_transform_ffn`: `x = h + conv(h)` on the LN output h)."""

    def __init__(self, dim: int, num_heads: int, window: int, share_num: int,
                 init_shift: bool, resolution: tuple[int, int],
                 mlp_ratio: float = 4.0, drop_path_rates: Sequence[float] = (0.0,),
                 use_kernel: bool = True, is_sep_layernorm: bool = True,
                 is_transform_heads: bool = True, is_transform_ffn: bool = True, *,
                 dtype, device):
        super().__init__()
        self.share_num, self.init_shift = share_num, init_shift
        self.drop_path_rates, self.dtype = tuple(drop_path_rates), dtype
        self.is_sep_layernorm = is_sep_layernorm
        self.is_transform_heads, self.is_transform_ffn = is_transform_heads, is_transform_ffn
        self.window = min(window, *resolution)
        kw = dict(device=device)
        self.attn = SwinWindowAttention(dim, self.window, num_heads,
                                        use_kernel=use_kernel, dtype=dtype, **kw)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, dtype=dtype, **kw)
        reps = range(share_num)
        if is_sep_layernorm:
            self.norm1_list = nn.ModuleList(nn.LayerNorm(dim, eps=1e-5, **kw) for _ in reps)
            self.norm2_list = nn.ModuleList(nn.LayerNorm(dim, eps=1e-5, **kw) for _ in reps)
        else:
            self.norm1 = nn.LayerNorm(dim, eps=1e-5, **kw)
            self.norm2 = nn.LayerNorm(dim, eps=1e-5, **kw)
        if is_transform_heads:
            self.proj_l = nn.ModuleList(nn.Linear(num_heads, num_heads, **kw) for _ in reps)
            self.proj_w = nn.ModuleList(nn.Linear(num_heads, num_heads, **kw) for _ in reps)
        if is_transform_ffn:
            self.local_norm_list = nn.ModuleList(nn.LayerNorm(dim, eps=1e-5, **kw)
                                                 for _ in reps)
            self.local_conv_list = nn.ModuleList(nn.Conv2d(dim, dim, 7, padding=3,
                                                           groups=dim, **kw) for _ in reps)

    def _norm(self, which: int, r: int) -> nn.LayerNorm:
        if self.is_sep_layernorm:
            return (self.norm1_list if which == 1 else self.norm2_list)[r]
        return self.norm1 if which == 1 else self.norm2

    def _head_transform(self, fc: nn.Linear):
        """fc as the JAX package's Dense(dtype) applies it: input and
        output in the compute dtype."""
        return lambda t: linear(fc, t.to(self.dtype), self.dtype)

    def _local_conv(self, r: int, h: torch.Tensor) -> torch.Tensor:
        conv = self.local_conv_list[r]
        y = F.conv2d(h.permute(0, 3, 1, 2), conv.weight.to(self.dtype),
                     conv.bias.to(self.dtype), padding=3, groups=conv.groups)
        return y.permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None,
                captures: dict | None = None) -> torch.Tensor:
        """With `captures` ({"qkv_states": [], "hidden": []}), each repeat
        appends its attention's qkv (3, B·windows, heads, N, d) and its
        output (B, H·W, C), as the JAX package sows them."""
        B, H, W, C = x.shape
        eval_, dt = not self.training, self.dtype
        is_shift = self.init_shift
        for r in range(self.share_num):
            shift = self.window // 2 if (is_shift and self.window < min(H, W)) else 0
            transforms = {}
            if self.is_transform_heads:
                transforms = dict(proj_l=self._head_transform(self.proj_l[r]),
                                  proj_w=self._head_transform(self.proj_w[r]))
            h = swin_attend(layer_norm(self._norm(1, r), x, dt), self.attn,
                            self.window, shift, **transforms,
                            capture=None if captures is None else captures["qkv_states"])
            x = x + drop_path(h, self.drop_path_rates[r], eval_, generator)
            if self.is_transform_ffn:
                h = layer_norm(self.local_norm_list[r], x, dt)
                x = h + self._local_conv(r, h)
            h = self.mlp(layer_norm(self._norm(2, r), x, dt))
            x = x + drop_path(h, self.drop_path_rates[r], eval_, generator)
            if captures is not None:
                captures["hidden"].append(x.reshape(B, H * W, C))
            is_shift = not is_shift
        return x


class MiniSwin(_Pyramid):
    """Swin with weight multiplexing: stage s's depths[s] executed layers
    share depths[s] // share physical blocks, share = min(share_num,
    depths[s]) (BasicLayer grouping, swin_transformer_minivit.py:487-504).

    `is_sep_layernorm`, `is_transform_heads`, `is_transform_ffn`: MiniViT's
    switches (every registered variant has all three on). With
    `capture_distill` the forward returns (logits, captures): MiniViT's
    distillation states in the JAX package's `intermediates` order, as
    {"qkv_states": [...], "hidden": [...]}, one entry per executed layer in
    call order (`MiniSwinBlock.forward`). Capture takes the attention's
    plain route, as JAX's `sow_qkv` does; without it the forward is
    unchanged."""

    def __init__(self, img_size: int = 224, num_classes: int = 1000,
                 embed_dims: Sequence[int] = (96, 192, 384, 768),
                 depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window_size: int = 7,
                 mlp_ratio: float = 4.0, share_num: int = 2,
                 drop_path_rate: float = 0.1, use_kernel: bool = True,
                 is_sep_layernorm: bool = True, is_transform_heads: bool = True,
                 is_transform_ffn: bool = True, capture_distill: bool = False, *,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__(img_size, num_classes, embed_dims, dtype, device)
        self.capture_distill = capture_distill
        total = sum(depths)
        dpr = [drop_path_rate * i / max(total - 1, 1) for i in range(total)]
        switches = dict(is_sep_layernorm=is_sep_layernorm,
                        is_transform_heads=is_transform_heads,
                        is_transform_ffn=is_transform_ffn)

        def blocks(s, res):
            share = min(share_num, depths[s])
            base = sum(depths[:s])
            return [MiniSwinBlock(embed_dims[s], num_heads[s], window_size, share,
                                  (b * share) % 2 == 1, res, mlp_ratio,
                                  dpr[base + b * share: base + (b + 1) * share],
                                  use_kernel, **switches, dtype=dtype, device=device)
                    for b in range(depths[s] // share)]
        self._stages(embed_dims, depths, blocks, dtype, device)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None):
        if not self.capture_distill:
            return super().forward(x, generator)
        captures = {"qkv_states": [], "hidden": []}
        x = self.embed(x)
        for layer in self.layers:
            for block in layer.blocks:
                x = block(x, generator, captures)
            if layer.downsample is not None:
                x = layer.downsample(x)
        return self.pool_head(x), captures


# ---- registry ----

_SWIN = {
    "swin_tiny": ((96, 192, 384, 768), (2, 2, 6, 2), (3, 6, 12, 24), 0.2),
    "swin_small": ((96, 192, 384, 768), (2, 2, 18, 2), (3, 6, 12, 24), 0.3),
    "swin_base": ((128, 256, 512, 1024), (2, 2, 18, 2), (4, 8, 16, 32), 0.5),
}

# searched S3 configs (AutoFormerV2/configs/S3-{T,S,B}.yaml); their drop
# path is SwinTransformer's default 0.1, as in the JAX package's registry
_S3 = {
    "s3_tiny": dict(embed_dims=(96, 192, 384, 768), depths=(2, 2, 6, 2),
                    num_heads=((3, 3), (6, 6), (12,) * 6, (24, 24)),
                    window_sizes=((7, 7), (7, 7), (14,) * 6, (7, 7))),
    "s3_small": dict(embed_dims=(96, 192, 384, 768), depths=(2, 2, 18, 2),
                     num_heads=((3, 3), (6, 6), (12,) * 18, (24, 24)),
                     window_sizes=((14, 14), (14, 14), (14,) * 18, (14, 14))),
    "s3_base": dict(embed_dims=(96, 192, 384, 768), depths=(2, 2, 30, 2),
                    num_heads=((3, 3), (6, 6), (12,) * 30, (24, 24)),
                    window_sizes=((7, 7), (7, 7), (14,) * 30, (7, 7))),
}

# share_num: tiny 6 (configs/swin_tiny_..._minivit_sharenum6.yaml), small/base 2
_MINI_SWIN = {
    "mini_swin_tiny": ((96, 192, 384, 768), (2, 2, 6, 2), (3, 6, 12, 24), 0.2, 6),
    "mini_swin_small": ((96, 192, 384, 768), (2, 2, 18, 2), (3, 6, 12, 24), 0.3, 2),
    "mini_swin_base": ((128, 256, 512, 1024), (2, 2, 18, 2), (4, 8, 16, 32), 0.5, 2),
}


def _factory(name: str, cls, cfg: dict, default_dp: float):
    def factory(num_classes: int = 1000, drop_path_rate: float | None = None,
                img_size: int = 224, use_kernel: bool = True, *, device,
                dtype=torch.float32, **options):
        """`options`: the class's other keyword arguments (Mini-Swin's
        switches and `capture_distill`)."""
        dp = default_dp if drop_path_rate is None else drop_path_rate
        return cls(img_size=img_size, num_classes=num_classes, drop_path_rate=dp,
                   use_kernel=use_kernel, dtype=dtype, device=device, **cfg, **options)
    factory.__name__ = name
    return factory


for _name, (_d, _de, _h, _p) in _SWIN.items():
    register_model(_factory(_name, SwinTransformer,
                            dict(embed_dims=_d, depths=_de, num_heads=_h), _p))
for _name, _cfg in _S3.items():
    register_model(_factory(_name, SwinTransformer, dict(_cfg, head_dim=32), 0.1))
for _name, (_d, _de, _h, _p, _sh) in _MINI_SWIN.items():
    register_model(_factory(_name, MiniSwin, dict(embed_dims=_d, depths=_de,
                                                  num_heads=_h, share_num=_sh), _p))
