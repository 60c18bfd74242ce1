"""ResNet families: CLIP's ModifiedResNet image tower and the RN-family
two-tower CLIP, and the torchvision-style frozen-BN ResNet that DETR uses
as its backbone.

Counterpart of `cream_tpu/models/resnet.py`. NHWC in and out; each conv
sees the NCHW view of an NHWC map.

  * CLIP (TinyCLIP/src/open_clip/resnet.py: a 3-conv stem, anti-aliased
    avg-pool downsampling, attention pooling), eval only: BatchNorm runs
    from its stored statistics. Parameter names are open_clip's
    (`conv1`/`bn1`.. `conv3`/`bn3`, `layer{l}.{b}.conv{1,2,3}`,
    `...downsample.0` (conv) / `.1` (BN),
    `attnpool.{positional_embedding,q_proj,k_proj,v_proj,c_proj}`), and the
    two-tower model keeps the text tower's at the top level, so an OpenAI
    RN50 or RN101 state_dict loads as it is.
  * DETR (iRPE/DETR-with-iRPE/models/backbone.py): `ResNet` (7x7 stem,
    max-pool, torchvision's BasicBlock / Bottleneck with the stride on the
    3x3 conv) under `ResNetBackbone.body`, every BN a `FrozenBatchNorm`
    whose `weight`, `bias`, `running_mean` and `running_var` are buffers
    that no optimizer sees. Names are torchvision's (`body.conv1`,
    `body.bn1`, `body.layer{l}.{b}.conv{1,2,3}` / `bn{1,2,3}`,
    `...downsample.0` / `.1`), so the backbone of a released DETR
    checkpoint loads as it is.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from cream_tpu_torch.models.clip import TextTower, _normalized
from cream_tpu_torch.models.registry import register_model
from cream_tpu_torch.nn.layers import linear


def _conv_bn_relu(conv: nn.Conv2d, bn: nn.BatchNorm2d, x: torch.Tensor, dtype,
                  relu: bool = True) -> torch.Tensor:
    """NHWC conv (no bias) then eval BN (fp32 statistics, the output in the
    conv's dtype), then ReLU."""
    y = F.conv2d(x.permute(0, 3, 1, 2), conv.weight.to(dtype), None, conv.stride,
                 conv.padding)
    y = F.batch_norm(y, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                     False, 0.0, bn.eps).permute(0, 2, 3, 1)
    return F.relu(y) if relu else y


def _avg_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k stride-k average pool of an NHWC map. It pools a contiguous
    NCHW copy: torch's CUDA avg_pool2d backward is wrong on a channels_last
    input (see `models.darts.avg_pool`)."""
    y = F.avg_pool2d(x.permute(0, 3, 1, 2).contiguous(), k, k)
    return y.permute(0, 2, 3, 1)


class CLIPBottleneck(nn.Module):
    """1x1 -> 3x3 -> (avg-pool when strided) -> 1x1; every conv has stride 1,
    and the downsample path avg-pools before its 1x1 conv (resnet.py:7-53)."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1, *,
                 dtype: torch.dtype, device=None):
        super().__init__()
        self.stride, self.dtype = stride, dtype
        out = planes * self.expansion
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False, device=device)
        self.bn1 = nn.BatchNorm2d(planes, device=device)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False, device=device)
        self.bn2 = nn.BatchNorm2d(planes, device=device)
        self.conv3 = nn.Conv2d(planes, out, 1, bias=False, device=device)
        self.bn3 = nn.BatchNorm2d(out, device=device)
        if stride > 1 or inplanes != out:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, out, 1, bias=False, device=device),
                nn.BatchNorm2d(out, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        h = _conv_bn_relu(self.conv1, self.bn1, x, dt)
        h = _conv_bn_relu(self.conv2, self.bn2, h, dt)
        if self.stride > 1:
            h = _avg_pool(h, self.stride)
        h = _conv_bn_relu(self.conv3, self.bn3, h, dt, relu=False)
        if hasattr(self, "downsample"):
            if self.stride > 1:
                x = _avg_pool(x, self.stride)
            x = _conv_bn_relu(self.downsample[0], self.downsample[1], x, dt, relu=False)
        return F.relu(h + x)


class AttentionPool2d(nn.Module):
    """QKV attention pooling: the mean token is prepended, a positional
    embedding added, and only the mean token queries (resnet.py:56-93).
    q is scaled in the compute dtype, the scores and softmax are fp32, and
    P (cast to the compute dtype) · V sums in the compute dtype's matmul,
    as the JAX package's einsum does."""

    def __init__(self, spacial_dim: int, embed_dim: int, num_heads: int,
                 output_dim: int | None = None, *, dtype: torch.dtype, device=None):
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        self.positional_embedding = nn.Parameter(
            torch.randn(spacial_dim ** 2 + 1, embed_dim, device=device) / embed_dim ** 0.5)
        self.q_proj = nn.Linear(embed_dim, embed_dim, device=device)
        self.k_proj = nn.Linear(embed_dim, embed_dim, device=device)
        self.v_proj = nn.Linear(embed_dim, embed_dim, device=device)
        self.c_proj = nn.Linear(embed_dim, output_dim or embed_dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        dt, h = self.dtype, self.num_heads
        d = C // h
        t = x.reshape(B, H * W, C)
        t = torch.cat([t.mean(1, keepdim=True), t], 1) + self.positional_embedding.to(dt)
        q = linear(self.q_proj, t[:, :1], dt).view(B, 1, h, d).transpose(1, 2) * d ** -0.5
        k = linear(self.k_proj, t, dt).view(B, -1, h, d).transpose(1, 2)
        v = linear(self.v_proj, t, dt).view(B, -1, h, d).transpose(1, 2)
        attn = torch.softmax(torch.matmul(q.float(), k.float().transpose(-1, -2)), -1)
        out = torch.matmul(attn.to(dt), v).transpose(1, 2).reshape(B, C)
        return linear(self.c_proj, out, dt)


class ModifiedResNet(nn.Module):
    """CLIP's RN50-style image tower (resnet.py:96-190): forward(images NHWC,
    normalized=False) -> (B, output_dim)."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), output_dim: int = 1024,
                 heads: int = 32, image_size: int = 224, width: int = 64, *,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype, self.img_size = dtype, image_size
        stem = [3, width // 2, width // 2, width]
        for i in range(3):
            setattr(self, f"conv{i + 1}", nn.Conv2d(stem[i], stem[i + 1], 3,
                                                    stride=2 if i == 0 else 1, padding=1,
                                                    bias=False, device=device))
            setattr(self, f"bn{i + 1}", nn.BatchNorm2d(stem[i + 1], device=device))
        inplanes = width
        for li, (blocks, planes) in enumerate(zip(layers, [width, width * 2, width * 4,
                                                           width * 8])):
            stage = []
            for bi in range(blocks):
                stride = 2 if bi == 0 and li > 0 else 1
                stage.append(CLIPBottleneck(inplanes, planes, stride, dtype=dtype,
                                            device=device))
                inplanes = planes * CLIPBottleneck.expansion
            setattr(self, f"layer{li + 1}", nn.Sequential(*stage))
        self.attnpool = AttentionPool2d(image_size // 32, width * 32, heads, output_dim,
                                        dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, normalized: bool = False) -> torch.Tensor:
        dt = self.dtype
        x = x.to(dt)
        for i in (1, 2, 3):
            x = _conv_bn_relu(getattr(self, f"conv{i}"), getattr(self, f"bn{i}"), x, dt)
        x = _avg_pool(x, 2)
        for li in (1, 2, 3, 4):
            x = getattr(self, f"layer{li}")(x)
        x = self.attnpool(x)
        return _normalized(x) if normalized else x


class FrozenBatchNorm(nn.Module):
    """BatchNorm with its statistics and affine frozen (backbone.py
    FrozenBatchNorm2d, eps 1e-5): `weight`, `bias`, `running_mean` and
    `running_var` are buffers. Applied to an NCHW view; computes in fp32
    and returns `dtype`, as the JAX package's does."""

    def __init__(self, features: int, eps: float = 1e-5, *, dtype: torch.dtype, device=None):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.register_buffer("weight", torch.ones(features, device=device))
        self.register_buffer("bias", torch.zeros(features, device=device))
        self.register_buffer("running_mean", torch.zeros(features, device=device))
        self.register_buffer("running_var", torch.ones(features, device=device))

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        w = self.weight * torch.rsqrt(self.running_var + self.eps)
        b = self.bias - self.running_mean * w
        return (y * w[:, None, None] + b[:, None, None]).to(self.dtype)


def _conv_frozen_bn(conv: nn.Conv2d, bn: FrozenBatchNorm, x: torch.Tensor,
                    relu: bool = True) -> torch.Tensor:
    """NHWC bias-free conv in the frozen BN's dtype, the frozen BN, ReLU."""
    y = F.conv2d(x.permute(0, 3, 1, 2), conv.weight.to(bn.dtype), None, conv.stride,
                 conv.padding)
    y = bn(y).permute(0, 2, 3, 1)
    return F.relu(y) if relu else y


def _tv_conv(cin: int, cout: int, k: int, stride: int = 1, device=None) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, k // 2, bias=False, device=device)


class _FrozenBlock(nn.Module):
    """The projection shortcut (`downsample.0` conv, `.1` frozen BN) where
    the stride or the width changes."""

    def _shortcut(self, inplanes: int, out: int, stride: int, dtype, device) -> None:
        if stride != 1 or inplanes != out:
            self.downsample = nn.Sequential(_tv_conv(inplanes, out, 1, stride, device),
                                            FrozenBatchNorm(out, dtype=dtype, device=device))

    def _residual(self, x: torch.Tensor) -> torch.Tensor:
        if hasattr(self, "downsample"):
            return _conv_frozen_bn(self.downsample[0], self.downsample[1], x, relu=False)
        return x


class BasicBlock(_FrozenBlock):
    """3x3 (stride) -> 3x3, frozen BN (torchvision BasicBlock)."""

    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1, *, dtype: torch.dtype,
                 device=None):
        super().__init__()
        self.conv1 = _tv_conv(inplanes, planes, 3, stride, device)
        self.bn1 = FrozenBatchNorm(planes, dtype=dtype, device=device)
        self.conv2 = _tv_conv(planes, planes, 3, 1, device)
        self.bn2 = FrozenBatchNorm(planes, dtype=dtype, device=device)
        self._shortcut(inplanes, planes, stride, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = _conv_frozen_bn(self.conv1, self.bn1, x)
        h = _conv_frozen_bn(self.conv2, self.bn2, h, relu=False)
        return F.relu(h + self._residual(x))


class Bottleneck(_FrozenBlock):
    """1x1 -> 3x3 (stride) -> 1x1 x4, frozen BN (torchvision Bottleneck)."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1, *, dtype: torch.dtype,
                 device=None):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = _tv_conv(inplanes, planes, 1, 1, device)
        self.bn1 = FrozenBatchNorm(planes, dtype=dtype, device=device)
        self.conv2 = _tv_conv(planes, planes, 3, stride, device)
        self.bn2 = FrozenBatchNorm(planes, dtype=dtype, device=device)
        self.conv3 = _tv_conv(planes, out, 1, 1, device)
        self.bn3 = FrozenBatchNorm(out, dtype=dtype, device=device)
        self._shortcut(inplanes, out, stride, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = _conv_frozen_bn(self.conv1, self.bn1, x)
        h = _conv_frozen_bn(self.conv2, self.bn2, h)
        h = _conv_frozen_bn(self.conv3, self.bn3, h, relu=False)
        return F.relu(h + self._residual(x))


class ResNet(nn.Module):
    """torchvision-layout trunk: NHWC images -> the stride-32 NHWC map."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), block: str = "bottleneck",
                 width: int = 64, *, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        cls = Bottleneck if block == "bottleneck" else BasicBlock
        self.conv1 = nn.Conv2d(3, width, 7, 2, 3, bias=False, device=device)
        self.bn1 = FrozenBatchNorm(width, dtype=dtype, device=device)
        inplanes = width
        for li, blocks in enumerate(layers):
            planes = width * 2 ** li
            stage = []
            for bi in range(blocks):
                stage.append(cls(inplanes, planes, 2 if bi == 0 and li > 0 else 1, dtype=dtype,
                                 device=device))
                inplanes = planes * cls.expansion
            setattr(self, f"layer{li + 1}", nn.Sequential(*stage))
        self.num_layers = len(layers)
        self.num_channels = inplanes

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _conv_frozen_bn(self.conv1, self.bn1, x.to(self.dtype))
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
        for li in range(self.num_layers):
            x = getattr(self, f"layer{li + 1}")(x)
        return x


def nearest_indices(in_size: int, out_size: int) -> np.ndarray:
    """The source index of each output of a nearest resize, as
    `jax.image.resize(..., "nearest")` computes it: floor((i + 0.5) * in /
    out) in float32 (half-pixel centres, torch's "nearest-exact")."""
    i = np.arange(out_size, dtype=np.float32)
    return np.floor((i + np.float32(0.5)) * np.float32(in_size) / np.float32(out_size)
                    ).astype(np.int64)


class ResNetBackbone(nn.Module):
    """DETR's backbone (backbone.py:73-95): (NHWC images, pixel mask (B, H,
    W), True = padding) -> (the stride-32 features, the mask
    nearest-downsampled to their grid)."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), block: str = "bottleneck", *,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.body = ResNet(layers, block, dtype=dtype, device=device)
        self.num_channels = self.body.num_channels

    def forward(self, images: torch.Tensor, pixel_mask: torch.Tensor):
        feat = self.body(images)
        (H, W), (h, w) = pixel_mask.shape[1:], feat.shape[1:3]
        rows = torch.from_numpy(nearest_indices(H, h)).to(pixel_mask.device)
        cols = torch.from_numpy(nearest_indices(W, w)).to(pixel_mask.device)
        return feat, pixel_mask[:, rows][:, :, cols]


def resnet50_backbone(*, dtype: torch.dtype = torch.float32, device=None) -> ResNetBackbone:
    return ResNetBackbone((3, 4, 6, 3), "bottleneck", dtype=dtype, device=device)


def resnet18_backbone(*, dtype: torch.dtype = torch.float32, device=None) -> ResNetBackbone:
    return ResNetBackbone((2, 2, 2, 2), "basic", dtype=dtype, device=device)


class CLIPResNet(TextTower):
    """Two-tower CLIP with a ModifiedResNet image tower (`visual`), the text
    tower (OpenAI RN checkpoints use QuickGELU) and `logit_scale`."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), embed_dim: int = 1024,
                 heads: int = 32, image_size: int = 224, width: int = 64,
                 text_width: int = 512, text_layers: int = 12, text_heads: int = 8,
                 context_length: int = 77, vocab_size: int = 49408,
                 quick_gelu: bool = True, *, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__(context_length, vocab_size, text_width, text_layers,
                         [text_heads] * text_layers, None, embed_dim,
                         "quick_gelu" if quick_gelu else "gelu", dtype=dtype, device=device)
        self.img_size = image_size
        self.visual = ModifiedResNet(layers, embed_dim, heads, image_size, width,
                                     dtype=dtype, device=device)
        self.logit_scale = nn.Parameter(torch.tensor(float(np.log(1 / 0.07)), device=device))

    def encode_image(self, image, normalized: bool = True):
        return self.visual(image, normalized=normalized)

    def forward(self, image, text):
        return self.encode_image(image), self.encode_text(text), self.logit_scale.exp()


# stage depths and embed dims of OpenAI's RN50 / RN101 (open_clip configs)
CLIP_RESNETS = {"clip_resnet50": ((3, 4, 6, 3), 1024), "clip_resnet101": ((3, 4, 23, 3), 512)}


def _rn_factory(name: str, layers, embed_dim: int, tower: bool):
    def factory(img_size: int = 224, *, device, dtype=torch.float32, **kw):
        if tower:
            return ModifiedResNet(layers, embed_dim, 32, img_size, dtype=dtype,
                                  device=device, **kw)
        return CLIPResNet(layers, embed_dim, 32, img_size, dtype=dtype, device=device, **kw)
    factory.__name__ = name
    return factory


for _name, (_layers, _dim) in CLIP_RESNETS.items():
    register_model(_rn_factory(_name, _layers, _dim, False))
    register_model(_rn_factory(f"{_name}_tower", _layers, _dim, True))
