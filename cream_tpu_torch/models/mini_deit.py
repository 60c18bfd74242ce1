"""Mini-DeiT: weight-multiplexed DeiT with iRPE (MiniViT).

Counterpart of `cream_tpu/models/mini_deit.py`
(MiniViT/Mini-DeiT/mini_vision_transformer.py). Each physical block runs its
shared qkv / proj / MLP weights `repeated_times` times (2 for the registered
variants); each repeat has its own LayerNorms (eps 1e-6), its own
contextual-product iRPE table on keys, its own bias-free 1x1 head
transforms `conv_l` (before the softmax) and `conv_w` (after it), and its
own drop path rate, drawn twice a repeat (attention and MLP). No cls token:
the iRPE skip is 0 and the head takes the token mean.

Rounding points are the JAX package's: q scaled in the compute dtype, fp32
scores plus the iRPE term; the head transforms take and give the compute
dtype (so in bf16 the softmax runs on bf16 scores), P·V with fp32 sums. No
TPU kernel lies on this path. Parameter names are the reference's:
`blocks.{i}.block.{attn.qkv,attn.proj,mlp.fc1,mlp.fc2}`,
`blocks.{i}.block.norm{1,2}.instances.{r}`,
`blocks.{i}.block.attn.rpe_k.instances.{r}.lookup_table_weight`,
`blocks.{i}.block.attn.conv_{l,w}.instances.{r}.weight` (h, h, 1, 1).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from cream_tpu_torch.models.deit_rpe import PatchEmbed
from cream_tpu_torch.models.registry import register_model
from cream_tpu_torch.models.swin import Mlp
from cream_tpu_torch.nn.layers import layer_norm, linear
from cream_tpu_torch.nn.rpe import IRPE
from cream_tpu_torch.ops.common import drop_path
from cream_tpu_torch.ops.rpe import get_rpe_config


def mini_deit_rpe_config():
    """mini_deit_models.py:9-19: contextual product on keys, shared head,
    skip 0."""
    return get_rpe_config(ratio=1.9, method="product", mode="ctx", shared_head=True,
                          skip=0, rpe_on="k")


class Repeated(nn.Module):
    """The reference's RepeatedModuleList: one module per repeat, under
    `instances.{r}`."""

    def __init__(self, modules):
        super().__init__()
        self.instances = nn.ModuleList(modules)

    def __getitem__(self, r: int) -> nn.Module:
        return self.instances[r]


class MiniDeiTAttention(nn.Module):
    """Shared qkv and proj; per repeat `rpe_k`, `conv_l`, `conv_w`."""

    def __init__(self, dim: int, num_heads: int, repeats: int, grid: tuple[int, int],
                 qkv_bias: bool = True, use_transform: bool = True, *, dtype, device):
        super().__init__()
        self.heads, self.dtype, self.use_transform = num_heads, dtype, use_transform
        d = dim // num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias, device=device)
        self.proj = nn.Linear(dim, dim, device=device)
        cfg = mini_deit_rpe_config().rpe_k
        self.rpe_k = Repeated(IRPE(d, num_heads, cfg, *grid, dtype=dtype, device=device)
                              for _ in range(repeats))
        if use_transform:
            for name in ("conv_l", "conv_w"):
                setattr(self, name, Repeated(
                    nn.Conv2d(num_heads, num_heads, 1, bias=False, device=device)
                    for _ in range(repeats)))

    def _heads(self, conv: nn.Conv2d, attn: torch.Tensor) -> torch.Tensor:
        """The 1x1 conv over the heads of (B, h, N, N), in and out in the
        compute dtype, as the JAX package's Dense over the head axis. (On
        the card its forward times as a batched matmul does, and its
        backward in 0.62x: tools/head_transform_ab.py.)"""
        return F.conv2d(attn.to(self.dtype), conv.weight.to(self.dtype))

    def forward(self, x: torch.Tensor, r: int) -> torch.Tensor:
        B, N, C = x.shape
        h, dt = self.heads, self.dtype
        d = C // h
        q, k, v = linear(self.qkv, x, dt).view(B, N, 3, h, d).permute(2, 0, 3, 1, 4)
        q = q * d ** -0.5
        attn = torch.matmul(q.float(), k.float().transpose(-1, -2)) + self.rpe_k[r](q)
        if self.use_transform:
            attn = self._heads(self.conv_l[r], attn)
        attn = torch.softmax(attn, dim=-1).to(dt)
        if self.use_transform:
            attn = self._heads(self.conv_w[r], attn)
        out = torch.matmul(attn.float(), v.float()).to(dt)
        return linear(self.proj, out.transpose(1, 2).reshape(B, N, C), dt)


class MiniDeiTBlock(nn.Module):
    """One physical block run `repeats` times: per repeat r,
    x += drop_path(attn(norm1[r](x), r)); x += drop_path(mlp(norm2[r](x)))."""

    def __init__(self, dim: int, num_heads: int, repeats: int, grid: tuple[int, int],
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 drop_path_rates: Sequence[float] = (0.0, 0.0),
                 use_transform: bool = True, *, dtype, device):
        super().__init__()
        self.repeats, self.dtype = repeats, dtype
        self.drop_path_rates = tuple(drop_path_rates)
        self.attn = MiniDeiTAttention(dim, num_heads, repeats, grid, qkv_bias,
                                      use_transform, dtype=dtype, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, dtype=dtype, device=device)
        for name in ("norm1", "norm2"):
            setattr(self, name, Repeated(nn.LayerNorm(dim, eps=1e-6, device=device)
                                         for _ in range(repeats)))

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        eval_, dt = not self.training, self.dtype
        for r in range(self.repeats):
            rate = self.drop_path_rates[r]
            h = self.attn(layer_norm(self.norm1[r], x, dt), r)
            x = x + drop_path(h, rate, eval_, generator)
            h = self.mlp(layer_norm(self.norm2[r], x, dt))
            x = x + drop_path(h, rate, eval_, generator)
        return x


class MiniDeiT(nn.Module):
    """`depth` executed layers on depth // repeated_times physical blocks;
    drop path grows linearly from 0 to `drop_path_rate` over the executed
    layers."""

    def __init__(self, num_classes: int = 1000, img_size: int = 224,
                 patch_size: int = 16, embed_dim: int = 384, depth: int = 12,
                 num_heads: int = 6, repeated_times: int = 2, mlp_ratio: float = 4.0,
                 drop_path_rate: float = 0.0, use_transform: bool = True, *,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if img_size % patch_size:
            raise ValueError(f"img_size {img_size} is not a multiple of patch {patch_size}")
        self.img_size, self.num_classes, self.dtype = img_size, num_classes, dtype
        grid = (img_size // patch_size,) * 2
        self.patch_embed = PatchEmbed(embed_dim, patch_size, dtype=dtype, device=device)
        self.pos_embed = nn.Parameter(torch.zeros(1, grid[0] * grid[1], embed_dim,
                                                  device=device))
        nn.init.trunc_normal_(self.pos_embed, std=0.02)
        dpr = [drop_path_rate * i / max(depth - 1, 1) for i in range(depth)]
        R = repeated_times
        self.blocks = nn.ModuleList(
            nn.ModuleDict({"block": MiniDeiTBlock(
                embed_dim, num_heads, R, grid, mlp_ratio, drop_path_rates=dpr[i * R:(i + 1) * R],
                use_transform=use_transform, dtype=dtype, device=device)})
            for i in range(depth // R))
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6, device=device)
        self.head = nn.Linear(embed_dim, num_classes, device=device)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """Logits of NHWC images. In train mode with drop path on,
        `generator` supplies its draws (required then)."""
        if tuple(x.shape[1:]) != (self.img_size, self.img_size, 3):
            raise ValueError(f"expected (B, {self.img_size}, {self.img_size}, 3)"
                             f" NHWC input, got {tuple(x.shape)}")
        x = self.patch_embed(x) + self.pos_embed.to(self.dtype)
        for block in self.blocks:
            x = block["block"](x, generator)
        x = layer_norm(self.norm, x, self.dtype).mean(dim=1)
        return linear(self.head, x, self.dtype)


# embed_dim, num_heads (DeiT Ti/S/B geometry, depth 12, 2 repeats)
_SIZES = {"tiny": (192, 3), "small": (384, 6), "base": (768, 12)}


def _factory(name: str, dim: int, heads: int):
    def factory(num_classes: int = 1000, drop_path_rate: float = 0.0,
                img_size: int = 224, *, device, dtype=torch.float32):
        return MiniDeiT(num_classes=num_classes, img_size=img_size, embed_dim=dim,
                        num_heads=heads, drop_path_rate=drop_path_rate, dtype=dtype,
                        device=device)
    factory.__name__ = name
    return factory


for _size, (_dim, _heads) in _SIZES.items():
    register_model(_factory(f"mini_deit_{_size}_patch16_224", _dim, _heads))
