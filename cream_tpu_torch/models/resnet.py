"""CLIP's ModifiedResNet image tower and the RN-family two-tower CLIP.

Counterpart of the CLIP half of `cream_tpu/models/resnet.py`
(TinyCLIP/src/open_clip/resnet.py: a 3-conv stem, anti-aliased avg-pool
downsampling, attention pooling), eval only: BatchNorm runs from its stored
statistics. NHWC in and out; each conv sees the NCHW view of an NHWC map.

Parameter names are open_clip's (`conv1`/`bn1`.. `conv3`/`bn3`,
`layer{l}.{b}.conv{1,2,3}`, `...downsample.0` (conv) / `.1` (BN),
`attnpool.{positional_embedding,q_proj,k_proj,v_proj,c_proj}`), and the
two-tower model keeps the text tower's at the top level, so an OpenAI RN50
or RN101 state_dict loads as it is. DETR's frozen-BN ResNet lives in the
same JAX module and is not part of this one.
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
    return F.avg_pool2d(x.permute(0, 3, 1, 2), k, k).permute(0, 2, 3, 1)


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
