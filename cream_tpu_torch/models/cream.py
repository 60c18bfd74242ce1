"""Cream: the MBConv one-shot supernet with a choice of operator per layer,
its meta-matching head, and the fixed childnets it yields.

Counterpart of `cream_tpu/models/cream.py` (Cream/lib/models/structures/
supernet.py, childnet.py): an EfficientNet-style stem, a fixed
depthwise-separable block, five searchable stages whose every layer picks
one of six InvertedResidual choices (kernel {3, 5, 7} x expansion {4, 6},
SE 0.25 with a hard-sigmoid gate, Swish), a 320-channel 1x1 conv block, the
1280-channel conv head and the classifier.

The JAX supernet runs all six choices of a layer and selects one (its
architecture is traced data). The port, with the path on the host, runs only
the chosen choice, as the reference routes it (supernet.py:105-126): the
loss, logits and grads are JAX's, and so are the chosen choice's BN
statistics. In train mode JAX's step also moves the running statistics of
the five choices it did not pick; the port's leaves them (ROADMAP Queue 3).
An entry of -1 skips a layer (never the first of a stage).

Every depthwise conv+BN pair goes through `nn.layers.conv_nchw` /
`batch_norm`, so `set_dw_kernel(model, "fused")` sends the 3x3 depthwise
sites to K7 (stride 1) and K9 (stride 2), and `"wgrad"` the stride-1 ones
to K8; `"library"` (the default, as the JAX package's `DEFAULT_DW_VJP =
False`) keeps cuDNN.

Parameter names are the timm names of the reference's childnets, which
`cream_tpu.zoo.import_torch.convert_cream_childnet` reads: `conv_stem`/`bn1`,
`blocks.0.0` (the depthwise-separable block: `conv_dw`/`bn1`, `se`,
`conv_pw`/`bn2`), `blocks.{s+1}.{i}` (`conv_pw`/`bn1`, `conv_dw`/`bn2`,
`se.conv_reduce`, `se.conv_expand`, `conv_pwl`/`bn3`), the tail
`blocks.{S+1}.0.conv`/`bn1`, `conv_head` (with bias), `classifier`. The
supernet has no torch importer in the JAX package; its choices are named
`blocks.{s+1}.{i}.{choice}.…`, each a childnet layer's names. Input NHWC.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from cream_tpu_torch.models.registry import register_model
from cream_tpu_torch.nn.layers import _check_dw_kernel, batch_norm, conv_nchw

# (channels, num_layers, stride) of the five searchable stages: the
# sta_num=(4,4,4,4,4) sizing (Cream/lib/utils/search_structure_supernet.py)
SEARCH_STAGES = ((24, 4, 2), (40, 4, 2), (80, 4, 2), (96, 4, 1), (192, 4, 2))
CHOICES = tuple((k, e) for k in (3, 5, 7) for e in (4, 6))  # 6 per layer
# per-stage default (kernel, expand) from the choice_block_pool strings
# (Cream/tools/test.py:81-86)
STAGE_DEFAULTS = ((3, 4), (5, 4), (3, 6), (3, 6), (5, 6))
MOMENTUM = 0.9        # flax's BN momentum, as ConvBN's


def swish(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """timm hard_sigmoid: relu6(x + 3) / 6, the SE gate (supernet.py
    se_kwargs)."""
    return F.relu6(x + 3.0) / 6.0


def make_divisible(v: float, divisor: int = 8, min_value: int | None = None) -> int:
    """timm make_divisible: SE reduced channels round to a multiple of 8."""
    min_value = min_value or divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def _conv(cin: int, cout: int, k: int = 1, stride: int = 1, groups: int = 1,
          bias: bool = False, device=None) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, k // 2, groups=groups, bias=bias, device=device)


def _bn(c: int, device) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-5, device=device)


class _Block(nn.Module):
    """Conv+BN pairs on NHWC maps through the shared depthwise routing."""

    def __init__(self, dtype: torch.dtype, dw_kernel: str):
        super().__init__()
        _check_dw_kernel(dw_kernel)
        self.dtype, self.dw_kernel = dtype, dw_kernel

    def conv_bn(self, conv: nn.Conv2d, bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
        y = conv_nchw(conv, x, conv.stride[0], conv.padding[0], conv.groups, self.dw_kernel)
        return batch_norm(bn, y, self.training, MOMENTUM).permute(0, 2, 3, 1)


class SqueezeExcite(nn.Module):
    """timm's EfficientNet SE as the reference configures it: the mean over
    the map, a 1x1 reduce (bias), ReLU, a 1x1 expand (bias), the
    hard-sigmoid gate."""

    def __init__(self, channels: int, reduce_chs: int, *, device=None):
        super().__init__()
        self.conv_reduce = _conv(channels, reduce_chs, bias=True, device=device)
        self.conv_expand = _conv(reduce_chs, channels, bias=True, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        r, e = self.conv_reduce, self.conv_expand
        s = x.mean(dim=(1, 2))
        s = F.relu(F.linear(s, r.weight.flatten(1).to(dt), r.bias.to(dt)))
        s = F.linear(s, e.weight.flatten(1).to(dt), e.bias.to(dt))
        return x * hard_sigmoid(s)[:, None, None, :]


class InvertedResidual(_Block):
    """MBConv: expand 1x1 -> depthwise kxk -> SE -> project 1x1, Swish
    after the first two; the residual where stride 1 keeps the width."""

    def __init__(self, in_chs: int, out_chs: int, kernel: int, expand: int, stride: int = 1,
                 se_ratio: float = 0.25, *, dtype: torch.dtype = torch.float32,
                 dw_kernel: str = "library", device=None):
        super().__init__(dtype, dw_kernel)
        mid = in_chs * expand
        self.has_residual = stride == 1 and in_chs == out_chs
        self.conv_pw, self.bn1 = _conv(in_chs, mid, device=device), _bn(mid, device)
        self.conv_dw = _conv(mid, mid, kernel, stride, groups=mid, device=device)
        self.bn2 = _bn(mid, device)
        self.se = SqueezeExcite(mid, make_divisible(mid * se_ratio), device=device)
        self.conv_pwl, self.bn3 = _conv(mid, out_chs, device=device), _bn(out_chs, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        y = swish(self.conv_bn(self.conv_pw, self.bn1, x))
        y = swish(self.conv_bn(self.conv_dw, self.bn2, y))
        y = self.conv_bn(self.conv_pwl, self.bn3, self.se(y))
        return y + x if self.has_residual else y


class DepthwiseSeparable(_Block):
    """The fixed first block: depthwise 3x3 -> Swish -> SE -> pointwise
    1x1 (no activation), the residual where the width is kept."""

    def __init__(self, in_chs: int, out_chs: int, *, dtype: torch.dtype = torch.float32,
                 dw_kernel: str = "library", device=None):
        super().__init__(dtype, dw_kernel)
        self.has_residual = in_chs == out_chs
        self.conv_dw = _conv(in_chs, in_chs, 3, groups=in_chs, device=device)
        self.bn1 = _bn(in_chs, device)
        self.se = SqueezeExcite(in_chs, make_divisible(in_chs * 0.25), device=device)
        self.conv_pw, self.bn2 = _conv(in_chs, out_chs, device=device), _bn(out_chs, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        y = self.se(swish(self.conv_bn(self.conv_dw, self.bn1, x)))
        y = self.conv_bn(self.conv_pw, self.bn2, y)
        return y + x if self.has_residual else y


class ConvBnAct(_Block):
    """The 320-channel 1x1 conv+BN+Swish tail (`conv`/`bn1`)."""

    def __init__(self, in_chs: int, out_chs: int, *, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__(dtype, "library")
        self.conv, self.bn1 = _conv(in_chs, out_chs, device=device), _bn(out_chs, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return swish(self.conv_bn(self.conv, self.bn1, x.to(self.dtype)))


class ChoiceLayer(nn.ModuleList):
    """The six InvertedResidual choices of a searchable layer (`CHOICES`
    order); `forward(x, op)` runs choice `op` alone, or skips the layer
    (op < 0) where it is `skippable`. A non-skippable layer given op < 0
    runs choice 0, as JAX's clipped index does."""

    def __init__(self, in_chs: int, out_chs: int, stride: int, skippable: bool, *,
                 dtype: torch.dtype, dw_kernel: str, device=None):
        super().__init__(InvertedResidual(in_chs, out_chs, k, e, stride, dtype=dtype,
                                          dw_kernel=dw_kernel, device=device)
                         for k, e in CHOICES)
        self.skippable = skippable

    def forward(self, x: torch.Tensor, op: int) -> torch.Tensor:
        if op < 0 and self.skippable:
            return x
        return self[min(max(op, 0), len(CHOICES) - 1)](x)


class _CreamNet(_Block):
    """Stem (`conv_stem`/`bn1`, stride 2), the depthwise-separable block,
    the stages (the subclass's), the tail, the head."""

    def __init__(self, num_classes: int, stem_chs: int, num_features: int, stages,
                 img_size: int, dtype: torch.dtype, dw_kernel: str, device):
        super().__init__(dtype, dw_kernel)
        self.num_classes, self.img_size = num_classes, img_size
        self.stages = tuple(tuple(s) for s in stages)
        kw = dict(dtype=dtype, device=device)
        self.conv_stem = nn.Conv2d(3, stem_chs, 3, 2, 1, bias=False, device=device)
        self.bn1 = _bn(stem_chs, device)
        self.blocks = nn.ModuleList(
            [nn.ModuleList([DepthwiseSeparable(stem_chs, 16, dw_kernel=dw_kernel, **kw)])]
            + [nn.ModuleList(layers) for layers in self._stage_layers(dw_kernel, kw)]
            + [nn.ModuleList([ConvBnAct(self.stages[-1][0], 320, **kw)])])
        self.conv_head = nn.Conv2d(320, num_features, 1, device=device)
        self.classifier = nn.Linear(num_features, num_classes, device=device)

    def _stage_layers(self, dw_kernel, kw):
        raise NotImplementedError

    def _stem(self, x: torch.Tensor) -> torch.Tensor:
        x = swish(self.conv_bn(self.conv_stem, self.bn1, x.to(self.dtype)))
        return self.blocks[0][0](x)

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = x.mean(dim=(1, 2))
        h = self.conv_head
        x = swish(F.linear(x, h.weight.flatten(1).to(dt), h.bias.to(dt)))
        return F.linear(x, self.classifier.weight.to(dt), self.classifier.bias.to(dt))


def num_search_layers(stages=SEARCH_STAGES) -> int:
    return sum(d for _, d, _ in stages)


def fixed_arch(stages, spec) -> list[int]:
    """A flat path from `spec`: "smallest" (every layer k3 e4, choice 0),
    "largest" (k7 e6, choice 5), "seed:N" (`nas.cream.sample_architecture`
    on default_rng(N)) or a sequence of choice ids."""
    n = num_search_layers(stages)
    if isinstance(spec, str):
        if spec in ("smallest", "largest"):
            return [0 if spec == "smallest" else len(CHOICES) - 1] * n
        if spec.startswith("seed:"):
            rng = np.random.default_rng(int(spec[5:]))
            return [int(a) for _, d, _ in stages
                    for a in rng.choice(len(CHOICES), size=d).tolist()]
        raise ValueError(f"config must be 'smallest', 'largest', 'seed:N' or a path, got {spec!r}")
    arch = [int(a) for a in np.asarray(spec).ravel()]
    if len(arch) != n:
        raise ValueError(f"a path of {len(arch)} layers for {n} searchable layers")
    return arch


def dw3x3_sites(stages=SEARCH_STAGES, batch: int = 1, img_size: int = 224
                ) -> list[tuple[int, tuple[int, int, int, int]]]:
    """(stride, NHWC input shape) of every depthwise 3x3 site a path can
    reach: the depthwise-separable block and each layer's k3 choices (both
    expansions), in order, duplicates dropped: the shapes K7 (stride 1) and
    K9 (stride 2) take on `"fused"`."""
    hw = (img_size + 1) // 2
    sites = [(1, (batch, hw, hw, 16))]
    in_chs = 16
    for chs, depth, stride in stages:
        for i in range(depth):
            s, cin = (stride, in_chs) if i == 0 else (1, chs)
            for k, e in CHOICES:
                if k == 3 and (s, (batch, hw, hw, cin * e)) not in sites:
                    sites.append((s, (batch, hw, hw, cin * e)))
            if i == 0:
                hw = (hw - 1) // stride + 1
        in_chs = chs
    return sites


def dw3x3_path_sites(arch, stages=SEARCH_STAGES, released_quirk: bool = False
                     ) -> tuple[int, int]:
    """(stride-1, stride-2) depthwise 3x3 sites one forward of a path runs:
    K7's and K9's launches a forward on `"fused"`. The depthwise-separable
    block is a stride-1 site; a layer is one where its op has kernel 3, at
    stride 2 where it opens a stride-2 stage. `arch` is a flat path (the
    supernet's: -1 skips a layer, a stage's first layer runs choice 0 then,
    as `ChoiceLayer`) or per-stage tuples (the childnet's);
    `released_quirk` as `CreamChildNet`'s."""
    if len(arch) and not isinstance(arch[0], (tuple, list)):
        flat, arch, li = [int(a) for a in np.asarray(arch).ravel()], [], 0
        for _, depth, _ in stages:
            ops = flat[li:li + depth]
            arch.append([max(ops[0], 0)] + [a for a in ops[1:] if a >= 0])
            li += depth
    s1, s2 = 1, 0
    for s, ((_, _, stride), ops) in enumerate(zip(stages, arch)):
        for i, op in enumerate(ops):
            single = released_quirk and len(ops) == 1
            if (STAGE_DEFAULTS[s] if single else CHOICES[min(op, len(CHOICES) - 1)])[0] == 3:
                s2, s1 = (s2 + 1, s1) if i == 0 and stride == 2 else (s2, s1 + 1)
    return s1, s2


class CreamSupernet(_CreamNet):
    """`forward(x, config=path)`: the flat path (one choice id per
    searchable layer, -1 skips a non-first layer) routes each layer to its
    chosen choice alone; without a path the one fixed at build time
    (`config=` "smallest", "largest", "seed:N" or a path) runs."""

    def __init__(self, num_classes: int = 1000, stem_chs: int = 16, num_features: int = 1280,
                 stages: Sequence = SEARCH_STAGES, img_size: int = 224, config=None, *,
                 dtype: torch.dtype = torch.float32, dw_kernel: str = "library", device=None):
        super().__init__(num_classes, stem_chs, num_features, stages, img_size, dtype,
                         dw_kernel, device)
        self.config = None if config is None else fixed_arch(self.stages, config)

    def _stage_layers(self, dw_kernel, kw):
        in_chs = 16
        for chs, depth, stride in self.stages:
            yield [ChoiceLayer(in_chs if i == 0 else chs, chs, stride if i == 0 else 1, i > 0,
                               dw_kernel=dw_kernel, **kw) for i in range(depth)]
            in_chs = chs

    @property
    def num_search_layers(self) -> int:
        return num_search_layers(self.stages)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None, *,
                config=None) -> torch.Tensor:
        arch = self.config if config is None else fixed_arch(self.stages, config)
        if arch is None:
            raise ValueError("CreamSupernet.forward needs a path (or one fixed at build)")
        x = self._stem(x)
        li = 0
        for stage in self.blocks[1:-1]:
            for layer in stage:
                x = layer(x, arch[li])
                li += 1
        return self._head(self.blocks[-1][0](x))


class MetaMatchingHead(nn.Module):
    """The 2-layer meta net that scores a (student - teacher) output
    difference, flattened (forward_meta, supernet.py:127): Linear(in,
    hidden) -> ReLU -> Linear(hidden, 1), a scalar. flax infers `in`; here
    it is the KD slice size x the number of classes."""

    def __init__(self, in_features: int, hidden: int = 256, *, device=None):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden, device=device)
        self.fc2 = nn.Linear(hidden, 1, device=device)

    def forward(self, diff: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.relu(self.fc1(diff.reshape(1, -1)))).reshape(())


class CreamChildNet(_CreamNet):
    """A fixed genotype (Cream/lib/models/structures/childnet.py): the
    supernet body with one op a layer. `arch` is per stage, one choice id a
    kept layer; a stage's layer i > 0 runs at stride 1.

    `released_quirk`: the reference's gen_childnet keeps the
    choice_block_pool default (kernel, expansion) in single-layer stages
    (childnet.py:113-117), so released checkpoints have those there; True
    for the released models, False for an extracted childnet."""

    def __init__(self, arch, num_classes: int = 1000, stem_chs: int = 16,
                 num_features: int = 1280, stages: Sequence = SEARCH_STAGES,
                 released_quirk: bool = False, img_size: int = 224, *,
                 dtype: torch.dtype = torch.float32, dw_kernel: str = "library", device=None):
        self.arch = tuple(tuple(int(a) for a in s) for s in arch)
        self.released_quirk = released_quirk
        super().__init__(num_classes, stem_chs, num_features, stages, img_size, dtype,
                         dw_kernel, device)

    def _stage_layers(self, dw_kernel, kw):
        in_chs = 16
        for s, (chs, _, stride) in enumerate(self.stages):
            single = len(self.arch[s]) == 1 and self.released_quirk
            layers = []
            for i, op in enumerate(self.arch[s]):
                k, e = STAGE_DEFAULTS[s] if single else CHOICES[op]
                layers.append(InvertedResidual(in_chs if i == 0 else chs, chs, k, e,
                                               stride if i == 0 else 1, dw_kernel=dw_kernel,
                                               **kw))
            yield layers
            in_chs = chs

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None, *,
                pyramid: bool = False):
        x = self._stem(x)
        feats = []
        for s, stage in enumerate(self.blocks[1:-1]):
            for layer in stage:
                x = layer(x)
            if s in (1, 3):          # the stride-8 and stride-16 stage ends
                feats.append(x)
        x = self.blocks[-1][0](x)
        if pyramid:
            return (*feats, x)       # strides (8, 16, 32)
        return self._head(x)

    def forward_pyramid(self, x: torch.Tensor) -> tuple:
        """C3/C4/C5 NHWC features (strides 8/16/32): the detection-backbone
        contract of the reference's NAS-found mobile backbones."""
        return self(x, pyramid=True)


def nest_arch(arch, stages=SEARCH_STAGES) -> tuple:
    """A flat path (-1 = skipped; the supernet's form) -> per-stage tuples
    of the kept layers' choice ids (the childnet's form)."""
    flat = [int(a) for a in np.asarray(arch).ravel()]
    out, li = [], 0
    for _, depth, _ in stages:
        out.append(tuple(a for a in flat[li:li + depth] if a >= 0))
        li += depth
    return tuple(out)


@torch.no_grad()
def extract_childnet(model: CreamSupernet, arch) -> CreamChildNet:
    """The childnet of the flat path `arch`: the chosen choice's params and
    BN statistics copied out of the supernet (the other five dropped), the
    kept layers renumbered densely; on the supernet's device, dtype and
    depthwise route, in eval mode."""
    flat = fixed_arch(model.stages, arch)
    child = CreamChildNet(nest_arch(flat, model.stages), model.num_classes,
                          model.blocks[0][0].conv_dw.in_channels,
                          model.conv_head.out_channels, model.stages,
                          img_size=model.img_size, dtype=model.dtype,
                          dw_kernel=model.dw_kernel, device=model.classifier.weight.device)
    remap, li = {}, 0
    for s, (_, depth, _) in enumerate(model.stages):
        dense = 0
        for i in range(depth):
            if flat[li] >= 0:
                remap[(s + 1, i)] = (dense, flat[li])
                dense += 1
            li += 1
    sd = {}
    n_stages = len(model.stages)
    for key, t in model.state_dict().items():
        parts = key.split(".")
        if parts[0] == "blocks" and 1 <= int(parts[1]) <= n_stages:
            hit = remap.get((int(parts[1]), int(parts[2])))
            if hit is None or int(parts[3]) != hit[1]:
                continue
            key = ".".join(["blocks", parts[1], str(hit[0])] + parts[4:])
        sd[key] = t
    child.load_state_dict(sd)
    return child.eval()


@register_model
def cream_supernet(num_classes: int = 1000, img_size: int = 224, config=None, *, device,
                   dtype=torch.float32, **kw):
    return CreamSupernet(num_classes=num_classes, img_size=img_size, config=config,
                         dtype=dtype, device=device, **kw)


@register_model
def cream_childnet(arch, num_classes: int = 1000, img_size: int = 224, *, device,
                   dtype=torch.float32, **kw):
    """`arch`: per-stage tuples of choice ids, or the flat supernet form
    (-1-padded; converted by `nest_arch`)."""
    arch = tuple(arch)
    if arch and not isinstance(arch[0], (tuple, list)):
        arch = nest_arch(arch, kw.get("stages", SEARCH_STAGES))
    return CreamChildNet(arch, num_classes=num_classes, img_size=img_size, dtype=dtype,
                         device=device, **kw)


# released-checkpoint genotypes (Cream/tools/test.py:52-76, the stem/tail
# [0] sentinels dropped; values index CHOICES)
RELEASED_CHILDNETS = {
    "cream_14": ((3,), (3, 3), (3, 3), (3,), (3,)),
    "cream_43": ((3,), (3, 1), (3, 1), (3, 3, 3), (3, 3)),
    "cream_114": ((3,), (3, 3), (3, 3), (3, 3, 3), (3, 3)),
    "cream_287": ((3,), (3, 3), (3, 1, 3), (3, 3, 3, 3), (3, 3, 3)),
    "cream_481": ((3, 4, 3, 1), (3, 2, 3, 0), (3, 3, 3, 1, 1), (3, 3, 3, 3),
                  (3, 3, 3, 3)),
    "cream_604": ((3, 3, 2, 3, 3), (3, 2, 3, 2, 3), (3, 2, 3, 2, 3),
                  (3, 3, 2, 2, 3, 3), (3, 3, 2, 3, 3, 3)),
}
# eval resolutions of the released models (test.py sets DATASET.IMAGE_SIZE)
RELEASED_CHILDNET_IMG_SIZE = {
    "cream_14": 64, "cream_43": 96, "cream_114": 160,
    "cream_287": 224, "cream_481": 224, "cream_604": 224,
}


def _released_factory(name: str, arch):
    def factory(num_classes: int = 1000, img_size: int = RELEASED_CHILDNET_IMG_SIZE[name], *,
                device, dtype=torch.float32, **kw):
        return CreamChildNet(arch, num_classes=num_classes, released_quirk=True,
                             img_size=img_size, dtype=dtype, device=device, **kw)
    factory.__name__ = name
    return factory


for _name, _arch in RELEASED_CHILDNETS.items():
    register_model(_released_factory(_name, _arch))
