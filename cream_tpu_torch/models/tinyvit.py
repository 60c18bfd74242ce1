"""TinyViT — hierarchical tiny ViT (conv stem + windowed bias-attention stages).

Counterpart of `cream_tpu/models/tinyvit.py`, eval and train. 4-stage pyramid:
  stage 0: MBConvs (after a stride-4 conv patch embed)
  stages 1-3: TinyViTBlocks = window bias-attention + depthwise local conv + MLP,
              PatchMerging (1x1 → 3x3 dw stride-2 → 1x1, all Conv+BN) between
Head: mean-pool tokens → LayerNorm → Linear.

Activations are NHWC throughout. Module and parameter names are those of the
released microsoft/Cream TinyViT (`patch_embed.seq.0.c.weight`,
`layers.{s}.blocks.{i}.attn.qkv.weight`, `layers.{s}.downsample.conv1...`,
`norm_head`, `head`), so released state_dicts load as they are.

The window of each block is min(window_size, H, W) at the stage's map size,
which follows from `img_size`; a model takes only inputs of that size.

Train mode follows `module.training`: BatchNorm uses batch statistics, and
drop path (per block, rate growing linearly from 0 at the first MBConv to
`drop_path_rate` at the last block) and MLP dropout (`drop_rate`) draw from
the `generator` passed to `forward`, the counterpart of the JAX package's
"drop_path"/"dropout" rngs.

`remat_stem` recomputes the stage-0 MBConvs' activations in the backward
instead of keeping them (`torch.utils.checkpoint`, the JAX `nn.remat`): a
memory knob for large batches or resolutions; losses, grads and BN
statistics are those without it.

Two routes of the JAX package, both off by default: `mbconv_kernel` runs the
stage-0 MBConvs' eval forward as one fused op (K6, `MBConv.use_kernel`, the
JAX `MBConv.use_pallas`), and `pin_layouts` passes each PatchMerging's output
through `ops.layout_pin.layout_pin` (K11, an identity copy, in eval and in
train).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from cream_tpu_torch.models.registry import register_model
from cream_tpu_torch.nn.act import gelu
from cream_tpu_torch.nn.attention import WindowBiasAttention
from cream_tpu_torch.nn.layers import ConvBN, MBConv, MlpLN, layer_norm, linear
from cream_tpu_torch.ops.common import drop_path
from cream_tpu_torch.ops.layout_pin import layout_pin


def _conv_s2_out(n: int) -> int:
    """Spatial size after a 3x3, stride-2, pad-1 conv."""
    return (n - 1) // 2 + 1


class GELU(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gelu(x)


class PatchEmbed(nn.Module):
    """Two stride-2 Conv+BN with GELU between: 4x spatial reduction."""

    def __init__(self, in_chans: int, embed_dim: int, *, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.seq = nn.Sequential(
            ConvBN(in_chans, embed_dim // 2, 3, 2, 1, **kw), GELU(),
            ConvBN(embed_dim // 2, embed_dim, 3, 2, 1, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.seq(x)


class PatchMerging(nn.Module):
    """1x1 ConvBN → GELU → 3x3 dw stride-2 ConvBN → GELU → 1x1 ConvBN (2x down)."""

    def __init__(self, dim: int, out_dim: int, *, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.conv1 = ConvBN(dim, out_dim, 1, **kw)
        self.conv2 = ConvBN(out_dim, out_dim, 3, 2, 1, groups=out_dim, **kw)
        self.conv3 = ConvBN(out_dim, out_dim, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = gelu(self.conv1(x))
        x = gelu(self.conv2(x))
        return self.conv3(x)


class TinyViTBlock(nn.Module):
    """Window bias-attention + residual, depthwise local conv, MLP + residual;
    drop path on both residual branches in train mode."""

    def __init__(self, dim: int, num_heads: int, window: int,
                 mlp_ratio: float = 4.0, drop: float = 0.0,
                 drop_path_rate: float = 0.0, local_conv_size: int = 3, *,
                 dtype, device):
        super().__init__()
        self.drop_path_rate = drop_path_rate
        kw = dict(dtype=dtype, device=device)
        self.attn = WindowBiasAttention(dim, dim // num_heads, num_heads,
                                        window, attn_ratio=1.0, **kw)
        self.local_conv = ConvBN(dim, dim, local_conv_size, 1,
                                 local_conv_size // 2, groups=dim, **kw)
        self.mlp = MlpLN(dim, int(dim * mlp_ratio), dim, dropout=drop, **kw)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        eval_ = not self.training
        x = x + drop_path(self.attn(x), self.drop_path_rate, eval_, generator)
        x = self.local_conv(x)
        h = self.mlp(x, generator)
        return x + drop_path(h, self.drop_path_rate, eval_, generator)


def remat(block: nn.Module, x: torch.Tensor,
          generator: torch.Generator | None) -> torch.Tensor:
    """`block(x, generator)` under `torch.utils.checkpoint`: its activations
    are recomputed in the backward instead of kept. The recomputation
    replays the forward's random draws (a copy of `generator` at its state
    before the block) and leaves the BatchNorm running statistics as the
    forward left them, so a step's loss, grads and statistics are those
    without remat (flax's `nn.remat` semantics)."""
    start = None if generator is None else generator.get_state()
    calls = []

    def run(x):
        if not calls:
            calls.append(1)
            return block(x, generator)
        gen = None
        if generator is not None:
            gen = torch.Generator(device=generator.device)
            gen.set_state(start)
        stats = [b.clone() for b in block.buffers()]
        try:                # the recomputation may stop early: restore anyway
            return block(x, gen)
        finally:
            with torch.no_grad():
                for b, kept in zip(block.buffers(), stats):
                    b.copy_(kept)

    return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)


class TinyViTLayer(nn.Module):
    """One stage: its blocks, then the PatchMerging into the next stage.
    With `remat`, each block's activations are recomputed in the backward
    (`remat`) when it trains."""

    def __init__(self, blocks: list[nn.Module], downsample: nn.Module | None,
                 remat: bool = False):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample
        self.remat = remat

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        for blk in self.blocks:
            if self.remat and self.training and torch.is_grad_enabled():
                x = remat(blk, x, generator)
            else:
                x = blk(x, generator)
        return x if self.downsample is None else self.downsample(x)


class TinyViT(nn.Module):
    """Full TinyViT. Input (B, img_size, img_size, 3) NHWC; output
    (B, num_classes) logits in `dtype`."""

    def __init__(self, img_size: int = 224, num_classes: int = 1000,
                 embed_dims: Sequence[int] = (96, 192, 384, 576),
                 depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 18),
                 window_sizes: Sequence[int] = (7, 7, 14, 7),
                 mlp_ratio: float = 4.0, drop_rate: float = 0.0,
                 drop_path_rate: float = 0.1, mbconv_expand_ratio: float = 4.0,
                 local_conv_size: int = 3, remat_stem: bool = False,
                 pin_layouts: bool = False, mbconv_kernel: bool = False, *,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.img_size, self.num_classes, self.dtype = img_size, num_classes, dtype
        self.pin_layouts = pin_layouts
        total_depth = sum(depths)
        dpr = [drop_path_rate * i / max(total_depth - 1, 1)
               for i in range(total_depth)]
        kw = dict(dtype=dtype, device=device)
        self.patch_embed = PatchEmbed(3, embed_dims[0], **kw)
        res = _conv_s2_out(_conv_s2_out(img_size))
        self.layers = nn.ModuleList()
        for s, depth in enumerate(depths):
            rates = dpr[sum(depths[:s]):sum(depths[:s + 1])]
            if s == 0:
                blocks = [MBConv(embed_dims[0], mbconv_expand_ratio, r,
                                 use_kernel=mbconv_kernel, **kw)
                          for r in rates]
            else:
                ws = min(window_sizes[s], res)
                blocks = [TinyViTBlock(embed_dims[s], num_heads[s], ws,
                                       mlp_ratio, drop_rate, r,
                                       local_conv_size, **kw)
                          for r in rates]
            down = None
            if s < len(depths) - 1:
                down = PatchMerging(embed_dims[s], embed_dims[s + 1], **kw)
                res = _conv_s2_out(res)
            self.layers.append(TinyViTLayer(blocks, down, remat=remat_stem and s == 0))
        self.norm_head = nn.LayerNorm(embed_dims[-1], eps=1e-5, device=device)
        if num_classes > 0:
            self.head = nn.Linear(embed_dims[-1], num_classes, device=device)
            nn.init.trunc_normal_(self.head.weight, std=0.02)
            nn.init.zeros_(self.head.bias)

    def forward_features(self, x: torch.Tensor,
                         generator: torch.Generator | None = None) -> torch.Tensor:
        if tuple(x.shape[1:]) != (self.img_size, self.img_size, 3):
            raise ValueError(f"expected (B, {self.img_size}, {self.img_size}, 3)"
                             f" NHWC input, got {tuple(x.shape)}")
        x = self.patch_embed(x)
        for layer in self.layers:
            x = layer(x, generator)
            if self.pin_layouts and layer.downsample is not None:
                x = layout_pin(x)
        return x

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """Logits of NHWC images. In train mode with drop path or dropout on,
        `generator` supplies their random draws (required then)."""
        x = self.forward_features(x, generator)
        x = x.mean(dim=(1, 2))                      # global token mean-pool
        x = layer_norm(self.norm_head, x, self.dtype)
        if self.num_classes > 0:
            x = linear(self.head, x, self.dtype)
        return x


_VARIANTS = {
    # name: (img_size, embed_dims, depths, num_heads, window_sizes, drop_path)
    "tiny_vit_5m_224": (224, (64, 128, 160, 320), (2, 2, 6, 2), (2, 4, 5, 10), (7, 7, 14, 7), 0.0),
    "tiny_vit_11m_224": (224, (64, 128, 256, 448), (2, 2, 6, 2), (2, 4, 8, 14), (7, 7, 14, 7), 0.1),
    "tiny_vit_21m_224": (224, (96, 192, 384, 576), (2, 2, 6, 2), (3, 6, 12, 18), (7, 7, 14, 7), 0.2),
    "tiny_vit_21m_384": (384, (96, 192, 384, 576), (2, 2, 6, 2), (3, 6, 12, 18), (12, 12, 24, 12), 0.1),
    "tiny_vit_21m_512": (512, (96, 192, 384, 576), (2, 2, 6, 2), (3, 6, 12, 18), (16, 16, 32, 16), 0.1),
}


def _make_factory(name, img_size, dims, depths, heads, windows, dp):
    def factory(num_classes: int = 1000, drop_path_rate: float | None = None,
                *, device, dtype=torch.float32, **kw):
        kw.setdefault("img_size", img_size)
        return TinyViT(num_classes=num_classes, embed_dims=dims, depths=depths,
                       num_heads=heads, window_sizes=windows,
                       drop_path_rate=dp if drop_path_rate is None else drop_path_rate,
                       dtype=dtype, device=device, **kw)
    factory.__name__ = name
    return factory


for _name, _cfg in _VARIANTS.items():
    register_model(_make_factory(_name, *_cfg))
