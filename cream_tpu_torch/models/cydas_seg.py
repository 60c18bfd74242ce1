"""CyDAS semantic segmentation, the CDARTS segmentation downstream.

Counterpart of `cream_tpu/models/cydas_seg.py` (CDARTS/CDARTS_segmentation/
train/cydas.py CyDASseg): the searched MobileNetV3-family ChildNet trunk,
built from Cream's `InvertedResidual` / `DepthwiseSeparable` (the reference
builds both from one timm-fork builder), feeding a BiSeNet-style aggregation
path (1x1 "arm" projections down 1/32 -> 1/16 -> 1/8 with 3x3 refinements
after each skip concat, a 1x1 fusion), a DeepLab-style decoder head at 1/4,
and in training two auxiliary heads at 1/16 and 1/32. Each head wraps a
SAGAN-style global self-attention run at half resolution (train/att_sa.py
Self_Attn + ATT; train/seg_oprs.py Head, Decoder).

Every bilinear rescale is `ops.resize.bilinear_resize` (two GEMMs with
interpolation matrices): align_corners=True around the attention, False in
the decoder and the model, as the reference mixes them. Every conv+BN pair
goes through `nn.layers.conv_nchw` / `batch_norm`, so `dw_kernel="fused"`
(`set_dw_kernel`) sends the six stride-1 depthwise 3x3 sites of the trunk to
K7 (`dw3x3_sites`); `"library"` (the default) keeps cuDNN. Train mode
follows `module.training` (the batch's BN statistics, flax's momentum);
`forward(x, aux=None)` runs the auxiliary heads in train mode unless told.

Parameter names are the reference CyDASseg's, which
`cream_tpu.zoo.import_torch.convert_cydas_seg` reads: `backbone.conv_stem`/
`bn1`, `backbone.blocks.{0..6}.*` (timm names), `arms32.{0,1}.conv.{0,1}`,
`refines32.{0,1}.conv.{0,1}`, `ffm.conv_1x1.{conv,bn}`,
`heads8.{feature_projection.conv.{0,1},att_sa,conv_3x3.{conv,bn},conv_1x1}`,
`heads{16,32}.{att_sa,conv_1x1}`; a Self_Attn block keeps its pipeline as
`net.{0,1,3,5,7,8}` (conv, BN, ATT, BN, conv, BN) and `shortcut.{0,1}`. The
trunk's `conv_head` / `classifier` of a released checkpoint are not used by
the segmentation forward and are not built. Input NHWC; outputs NHWC logits
at the input's resolution.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from cream_tpu_torch.models.cream import (ConvBnAct, DepthwiseSeparable, InvertedResidual,
                                          _bn, _conv, swish)
from cream_tpu_torch.models.registry import register_model
from cream_tpu_torch.nn.layers import batch_norm, conv_nchw
from cream_tpu_torch.ops.resize import bilinear_resize

# the decoded searched genotype: (out_chs, first-block stride, ((kernel,
# expand) per block)), from cydas.py's arch_list (cydas.py:240-282)
CYDAS_STAGES = (
    (24, 2, ((5, 6), (7, 4), (5, 4), (3, 4))),
    (40, 2, ((7, 6), (5, 4), (7, 4), (3, 4))),
    (80, 2, ((7, 4), (5, 6), (5, 4), (5, 4), (5, 4))),
    (96, 1, ((3, 6), (5, 6), (3, 4), (3, 6))),
    (192, 2, ((5, 4), (7, 4), (7, 4), (5, 4))),
)
# channels of the 1/4, 1/8, 1/16, 1/32 taps
CYDAS_F_CHANNELS = (24, 40, 96, 320)
MOMENTUM = 0.9


def _conv_bn(conv: nn.Conv2d, bn: nn.BatchNorm2d, x: torch.Tensor, training: bool,
             dtype: torch.dtype, relu: bool = True) -> torch.Tensor:
    """A bias-free conv in `dtype` and its BN on an NHWC map, then ReLU."""
    y = conv_nchw(conv, x.to(dtype), conv.stride[0], conv.padding[0], conv.groups)
    y = batch_norm(bn, y, training, MOMENTUM).permute(0, 2, 3, 1)
    return F.relu(y) if relu else y


def _conv_biased(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A 1x1 conv with bias on an NHWC map, as a linear in `dtype`."""
    return F.linear(x.to(dtype), conv.weight.flatten(1).to(dtype), conv.bias.to(dtype))


class CyDASBackbone(nn.Module):
    """The searched ChildNet trunk: stem (`conv_stem`/`bn1`, stride 2,
    Swish), the depthwise-separable block, five stages, the 320-channel 1x1
    tail; returns the taps at strides 4, 8, 16 and 32."""

    def __init__(self, stages=CYDAS_STAGES, *, dtype: torch.dtype = torch.float32,
                 dw_kernel: str = "library", device=None):
        super().__init__()
        self.dtype = dtype
        kw = dict(dtype=dtype, device=device)
        self.conv_stem = _conv(3, 16, 3, 2, device=device)
        self.bn1 = _bn(16, device)
        layers, in_chs = [], 16
        for chs, stride, blocks in stages:
            layers.append(nn.ModuleList(
                InvertedResidual(in_chs if i == 0 else chs, chs, k, e, stride if i == 0 else 1,
                                 dw_kernel=dw_kernel, **kw) for i, (k, e) in enumerate(blocks)))
            in_chs = chs
        self.blocks = nn.ModuleList(
            [nn.ModuleList([DepthwiseSeparable(16, 16, dw_kernel=dw_kernel, **kw)])] + layers
            + [nn.ModuleList([ConvBnAct(in_chs, 320, **kw)])])

    def forward(self, x: torch.Tensor) -> tuple:
        x = swish(_conv_bn(self.conv_stem, self.bn1, x, self.training, self.dtype, relu=False))
        x = self.blocks[0][0](x)
        feats = []
        for s, stage in enumerate(self.blocks[1:-1]):
            for layer in stage:
                x = layer(x)
            if s in (0, 1, 3):
                feats.append(x)
        feats.append(self.blocks[-1][0](x))
        return tuple(feats)


class ConvNorm(nn.Module):
    """The reference ConvNorm (operations.py:79-119): `conv.0` conv (no
    bias, pad k // 2), `conv.1` BN, ReLU."""

    def __init__(self, cin: int, cout: int, k: int = 3, *, dtype: torch.dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Sequential(_conv(cin, cout, k, device=device), _bn(cout, device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _conv_bn(self.conv[0], self.conv[1], x, self.training, self.dtype)


class ConvBnRelu(nn.Module):
    """The reference ConvBnRelu (seg_oprs.py): `conv`, `bn`, ReLU."""

    def __init__(self, cin: int, cout: int, k: int = 1, *, dtype: torch.dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.conv = _conv(cin, cout, k, device=device)
        self.bn = _bn(cout, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _conv_bn(self.conv, self.bn, x, self.training, self.dtype)


class FeatureFusion(nn.Module):
    """The 1x1 fusion after the refinements (`ffm.conv_1x1`)."""

    def __init__(self, cin: int, cout: int, *, dtype: torch.dtype, device=None):
        super().__init__()
        self.conv_1x1 = ConvBnRelu(cin, cout, 1, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_1x1(x)


class SAGANAttention(nn.Module):
    """The reference ATT (att_sa.py:200-231): single-head global attention
    with C/8-wide query and key projections and a learnable gate `gamma`
    (zero at init), all in the compute dtype."""

    def __init__(self, c: int, *, dtype: torch.dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.query_conv = _conv(c, c // 8, bias=True, device=device)
        self.key_conv = _conv(c, c // 8, bias=True, device=device)
        self.value_conv = _conv(c, c, bias=True, device=device)
        self.gamma = nn.Parameter(torch.zeros(1, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        dt = x.dtype
        q = _conv_biased(self.query_conv, x, dt).reshape(b, h * w, -1)
        k = _conv_biased(self.key_conv, x, dt).reshape(b, h * w, -1)
        v = _conv_biased(self.value_conv, x, dt).reshape(b, h * w, c)
        attn = torch.softmax(torch.matmul(q, k.transpose(1, 2)), dim=-1)
        out = torch.matmul(attn, v).reshape(b, h, w, c)
        return self.gamma.to(dt) * out + x


class SelfAttnBlock(nn.Module):
    """The reference Self_Attn (att_sa.py:127-198): at half resolution
    (bilinear, align_corners=True) 1x1-BN-ReLU -> global attention ->
    BN-ReLU -> 1x1-BN (its BN weight zero at init), resized back, added to
    a projection shortcut (1x1-BN-ReLU where the width changes), ReLU."""

    def __init__(self, cin: int, dim_out: int, *, dtype: torch.dtype, device=None):
        super().__init__()
        self.dtype = dtype
        if cin != dim_out:
            self.shortcut = nn.Sequential(_conv(cin, dim_out, device=device),
                                          _bn(dim_out, device))
        out_bn = _bn(dim_out, device)
        nn.init.zeros_(out_bn.weight)
        self.net = nn.ModuleDict({
            "0": _conv(cin, dim_out, device=device), "1": _bn(dim_out, device),
            "3": SAGANAttention(dim_out, dtype=dtype, device=device),
            "5": _bn(dim_out, device),
            "7": _conv(dim_out, dim_out, device=device), "8": out_bn})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, h, w, _ = x.shape
        dt, tr, net = self.dtype, self.training, self.net
        x = x.to(dt)
        if hasattr(self, "shortcut"):
            sc = _conv_bn(self.shortcut[0], self.shortcut[1], x, tr, dt)
        else:
            sc = x
        out = bilinear_resize(x, (h // 2, w // 2), align_corners=True)
        out = _conv_bn(net["0"], net["1"], out, tr, dt)
        out = net["3"](out)
        out = F.relu(batch_norm(net["5"], out.permute(0, 3, 1, 2), tr, MOMENTUM)
                     ).permute(0, 2, 3, 1)
        out = _conv_bn(net["7"], net["8"], out, tr, dt, relu=False)
        out = bilinear_resize(out, (h, w), align_corners=True)
        return F.relu(out + sc)


def _mid_planes(in_planes: int) -> int:
    """seg_oprs.py:239-251: halve only past 256 channels."""
    return in_planes if in_planes <= 256 else in_planes // 2


class SegHead(nn.Module):
    """The reference Head (seg_oprs.py:236-285): Self_Attn, 1x1 classifier."""

    def __init__(self, cin: int, num_classes: int, *, dtype: torch.dtype, device=None):
        super().__init__()
        self.dtype = dtype
        mid = _mid_planes(cin)
        self.att_sa = SelfAttnBlock(cin, mid, dtype=dtype, device=device)
        self.conv_1x1 = _conv(mid, num_classes, bias=True, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _conv_biased(self.conv_1x1, self.att_sa(x), self.dtype)


class SegDecoder(nn.Module):
    """The reference Decoder (seg_oprs.py:287-345): the 1/4 feature
    projected to 48 channels, the 1/8 feature attended and upsampled to
    1/4 (align_corners=False), concatenated, a 3x3 fusion, 1x1 classifier."""

    def __init__(self, cin: int, low_in: int, num_classes: int, low_chs: int = 48, *,
                 dtype: torch.dtype, device=None):
        super().__init__()
        self.dtype = dtype
        mid = _mid_planes(cin)
        self.feature_projection = ConvNorm(low_in, low_chs, 1, dtype=dtype, device=device)
        self.att_sa = SelfAttnBlock(cin, mid, dtype=dtype, device=device)
        self.conv_3x3 = ConvBnRelu(mid + low_chs, mid, 3, dtype=dtype, device=device)
        self.conv_1x1 = _conv(mid, num_classes, bias=True, device=device)

    def forward(self, x: torch.Tensor, low: torch.Tensor) -> torch.Tensor:
        low = self.feature_projection(low)
        x = self.att_sa(x)
        x = bilinear_resize(x, low.shape[1:3], align_corners=False)
        x = self.conv_3x3(torch.cat([x, low], -1))
        return _conv_biased(self.conv_1x1, x, self.dtype)


class CyDASSeg(nn.Module):
    """The whole model (cydas.py:333-432). forward(x NHWC, aux=None): in
    train mode (or with aux=True) the (pred8, pred16, pred32) triple, each
    at the input's resolution; else pred8 alone."""

    def __init__(self, num_classes: int = 19, Fch: int = 12, *,
                 dtype: torch.dtype = torch.float32, dw_kernel: str = "library", device=None):
        super().__init__()
        self.num_classes, self.dtype = num_classes, dtype
        kw = dict(dtype=dtype, device=device)
        c4, c8, c16, c32 = CYDAS_F_CHANNELS
        f16, f8 = 16 * Fch, 8 * Fch
        self.backbone = CyDASBackbone(dw_kernel=dw_kernel, **kw)
        self.arms32 = nn.ModuleList([ConvNorm(c32, f16, 1, **kw), ConvNorm(f16, f8, 1, **kw)])
        self.refines32 = nn.ModuleList([ConvNorm(f16 + c16, f16, 3, **kw),
                                        ConvNorm(f8 + c8, f8, 3, **kw)])
        self.ffm = FeatureFusion(f8, f8, **kw)
        self.heads8 = SegDecoder(f8, c4, num_classes, **kw)
        self.heads16 = SegHead(c16, num_classes, **kw)
        self.heads32 = SegHead(c32, num_classes, **kw)

    def forward(self, x: torch.Tensor, aux: bool | None = None):
        aux = self.training if aux is None else aux
        h, w = x.shape[1:3]
        o4, o8, o16, o32 = self.backbone(x.to(self.dtype))
        out = self.arms32[0](o32)
        out = bilinear_resize(out, o16.shape[1:3])
        out = self.refines32[0](torch.cat([out, o16], -1))
        out = self.arms32[1](out)
        out = bilinear_resize(out, o8.shape[1:3])
        out = self.refines32[1](torch.cat([out, o8], -1))
        out = self.ffm(out)
        pred8 = bilinear_resize(self.heads8(out, o4), (h, w))
        if not aux:
            return pred8
        return (pred8, bilinear_resize(self.heads16(o16), (h, w)),
                bilinear_resize(self.heads32(o32), (h, w)))


def dw3x3_sites(batch: int, h: int, w: int, stages=CYDAS_STAGES) -> list:
    """(stride, NHWC input shape) of every depthwise 3x3 site of the trunk
    at an (h, w) input, in order: the sites K7 (stride 1) and K9 (stride 2)
    take on `"fused"`, one launch each a forward (and one a backward)."""
    def down(n, s):
        return (n - 1) // s + 1
    h, w = down(h, 2), down(w, 2)
    sites = [(1, (batch, h, w, 16))]
    in_chs = 16
    for chs, stride, blocks in stages:
        for i, (k, e) in enumerate(blocks):
            s, cin = (stride, in_chs) if i == 0 else (1, chs)
            if k == 3:
                sites.append((s, (batch, h, w, cin * e)))
            if i == 0:
                h, w = down(h, s), down(w, s)
        in_chs = chs
    return sites


@register_model
def cydas_seg(num_classes: int = 19, *, device, dtype: torch.dtype = torch.float32,
              dw_kernel: str = "library", **kw):
    """Cityscapes CyDASseg (Fch 12, the released train_cydas.py config)."""
    return CyDASSeg(num_classes, dtype=dtype, dw_kernel=dw_kernel, device=device, **kw)
