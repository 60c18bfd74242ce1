"""DeiT / ViT with image relative position encodings (iRPE).

Counterpart of `cream_tpu/models/deit_rpe.py`
(iRPE/DeiT-with-iRPE/rpe_vision_transformer.py): a plain ViT (patch conv,
cls token, optional distillation token, learned pos_embed, pre-LN blocks at
LayerNorm eps 1e-6) whose attention adds the iRPE terms as the reference
does (:75-92):

    attn  = (q·scale) kᵀ             q scaled in the compute dtype, fp32 sums
    attn += rpe_k(q)                 contextual product on keys
    attn += rpe_q(k·scale)ᵀ
    out   = softmax(attn) v          softmax in fp32, P in the compute dtype
    out  += rpe_v(attn)              added in the compute dtype

No TPU kernel lies on this path: the attention and the iRPE gather are plain
tensor math, in JAX and here. Parameter names are the reference's
(`patch_embed.proj`, `cls_token`, `dist_token`, `pos_embed`,
`blocks.{i}.{norm1,attn.qkv,attn.proj,attn.rpe_k.lookup_table_weight,norm2,
mlp.fc1,mlp.fc2}`, `norm`, `head`, `head_dist`), so a released DeiT(+iRPE)
`.pth` loads through `zoo.load.load_pth`. Input NHWC; train mode follows
`module.training`, drop path draws from the generator given to `forward`.
A distilled model returns the (head, head_dist) pair in train mode and
their mean in eval.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from cream_tpu_torch.models.registry import register_model
from cream_tpu_torch.models.swin import Mlp
from cream_tpu_torch.nn.layers import layer_norm, linear
from cream_tpu_torch.nn.rpe import IRPE
from cream_tpu_torch.ops.common import drop_path
from cream_tpu_torch.ops.rpe import RPEConfig, get_rpe_config


class PatchEmbed(nn.Module):
    """p x p stride-p conv with bias: NHWC images -> (B, H/p·W/p, C) tokens,
    row-major over the grid."""

    def __init__(self, embed_dim: int, patch_size: int, *, dtype, device):
        super().__init__()
        self.dtype = dtype
        self.proj = nn.Conv2d(3, embed_dim, patch_size, patch_size, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x.to(self.dtype).permute(0, 3, 1, 2), self.proj.weight.to(self.dtype),
                     self.proj.bias.to(self.dtype), self.proj.stride)
        return y.flatten(2).transpose(1, 2)


class RPEAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, grid: tuple[int, int], skip: int,
                 qkv_bias: bool = True, rpe_config: RPEConfig | None = None, *,
                 dtype, device):
        super().__init__()
        self.heads, self.dtype = num_heads, dtype
        d = dim // num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias, device=device)
        self.proj = nn.Linear(dim, dim, device=device)
        for name in ("rpe_q", "rpe_k", "rpe_v"):
            cfg = None if rpe_config is None else getattr(rpe_config, name)
            setattr(self, name, None if cfg is None else IRPE(
                d, num_heads, cfg, *grid, skip=skip, transposed=name != "rpe_v",
                dtype=dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        h, dt = self.heads, self.dtype
        d = C // h
        scale = d ** -0.5
        q, k, v = linear(self.qkv, x, dt).view(B, N, 3, h, d).permute(2, 0, 3, 1, 4)
        q = q * scale
        attn = torch.matmul(q.float(), k.float().transpose(-1, -2))
        if self.rpe_k is not None:
            attn = attn + self.rpe_k(q)
        if self.rpe_q is not None:
            attn = attn + self.rpe_q(k * scale).transpose(-1, -2)
        attn = torch.softmax(attn, dim=-1).to(dt)
        out = torch.matmul(attn.float(), v.float()).to(dt)
        if self.rpe_v is not None:
            out = out + self.rpe_v(attn)
        return linear(self.proj, out.transpose(1, 2).reshape(B, N, C), dt)


class RPEBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, grid: tuple[int, int], skip: int,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 drop_path_rate: float = 0.0, rpe_config: RPEConfig | None = None, *,
                 dtype, device):
        super().__init__()
        self.drop_path_rate, self.dtype = drop_path_rate, dtype
        self.norm1 = nn.LayerNorm(dim, eps=1e-6, device=device)
        self.attn = RPEAttention(dim, num_heads, grid, skip, qkv_bias, rpe_config,
                                 dtype=dtype, device=device)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        eval_ = not self.training
        h = self.attn(layer_norm(self.norm1, x, self.dtype))
        x = x + drop_path(h, self.drop_path_rate, eval_, generator)
        h = self.mlp(layer_norm(self.norm2, x, self.dtype))
        return x + drop_path(h, self.drop_path_rate, eval_, generator)


class RPEVisionTransformer(nn.Module):
    """DeiT with optional iRPE (`rpe_config`) and distillation token
    (`distilled`). Drop path grows linearly from 0 to `drop_path_rate` over
    the blocks."""

    def __init__(self, num_classes: int = 1000, img_size: int = 224,
                 patch_size: int = 16, embed_dim: int = 384, depth: int = 12,
                 num_heads: int = 6, mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 drop_path_rate: float = 0.0, distilled: bool = False,
                 rpe_config: RPEConfig | None = None, *,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if img_size % patch_size:
            raise ValueError(f"img_size {img_size} is not a multiple of patch {patch_size}")
        self.img_size, self.num_classes = img_size, num_classes
        self.distilled, self.dtype = distilled, dtype
        grid = (img_size // patch_size,) * 2
        n_prefix = 2 if distilled else 1
        self.patch_embed = PatchEmbed(embed_dim, patch_size, dtype=dtype, device=device)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim, device=device))
        if distilled:
            self.dist_token = nn.Parameter(torch.zeros(1, 1, embed_dim, device=device))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, n_prefix + grid[0] * grid[1], embed_dim, device=device))
        for p in self.tokens() + [self.pos_embed]:
            nn.init.trunc_normal_(p, std=0.02)
        dpr = [drop_path_rate * i / max(depth - 1, 1) for i in range(depth)]
        self.blocks = nn.ModuleList(
            RPEBlock(embed_dim, num_heads, grid, n_prefix, mlp_ratio, qkv_bias, dpr[i],
                     rpe_config, dtype=dtype, device=device)
            for i in range(depth))
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6, device=device)
        self.head = nn.Linear(embed_dim, num_classes, device=device)
        if distilled:
            self.head_dist = nn.Linear(embed_dim, num_classes, device=device)

    def tokens(self) -> list[nn.Parameter]:
        """The prefix tokens: cls, then the distillation token if any."""
        return [self.cls_token, self.dist_token] if self.distilled else [self.cls_token]

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None):
        """Logits of NHWC images; a distilled model in train mode returns
        (logits, dist_logits). In train mode with drop path on, `generator`
        supplies its draws (required then)."""
        if tuple(x.shape[1:]) != (self.img_size, self.img_size, 3):
            raise ValueError(f"expected (B, {self.img_size}, {self.img_size}, 3)"
                             f" NHWC input, got {tuple(x.shape)}")
        B, dt = x.shape[0], self.dtype
        x = torch.cat([t.to(dt).expand(B, -1, -1) for t in self.tokens()]
                      + [self.patch_embed(x)], dim=1)
        x = x + self.pos_embed.to(dt)
        for block in self.blocks:
            x = block(x, generator)
        x = layer_norm(self.norm, x, dt)
        logits = linear(self.head, x[:, 0], dt)
        if not self.distilled:
            return logits
        logits_dist = linear(self.head_dist, x[:, 1], dt)
        if self.training:
            return logits, logits_dist
        return (logits + logits_dist) / 2


# embed_dim, depth, num_heads (DeiT Ti/S/B)
_SIZES = {"tiny": (192, 12, 3), "small": (384, 12, 6), "base": (768, 12, 12)}


def _factory(name: str, dim: int, depth: int, heads: int, rpe_on: str | None):
    def factory(num_classes: int = 1000, drop_path_rate: float = 0.0,
                img_size: int = 224, distilled: bool = False, *, device,
                dtype=torch.float32):
        # ctx-product-50-shared: ratio 1.9, contextual product, one table for
        # all heads, the cls token skipped (rpe_models.py:115-162)
        cfg = None if rpe_on is None else get_rpe_config(
            ratio=1.9, method="product", mode="ctx", shared_head=True, skip=1,
            rpe_on=rpe_on)
        return RPEVisionTransformer(num_classes=num_classes, img_size=img_size,
                                    embed_dim=dim, depth=depth, num_heads=heads,
                                    drop_path_rate=drop_path_rate, distilled=distilled,
                                    rpe_config=cfg, dtype=dtype, device=device)
    factory.__name__ = name
    return factory


for _size, (_dim, _depth, _heads) in _SIZES.items():
    register_model(_factory(f"deit_{_size}_patch16_224", _dim, _depth, _heads, None))
    for _on in ("k", "qk", "qkv"):
        register_model(_factory(f"deit_{_size}_patch16_224_ctx_product_50_shared_{_on}",
                                _dim, _depth, _heads, _on))
