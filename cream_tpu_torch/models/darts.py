"""DARTS cells and networks: the CDARTS model layer.

Counterpart of `cream_tpu/models/darts.py` (CDARTS/lib/models/{ops.py,
search_cells.py,augment_cells.py,model_augment.py,model_test.py} and
lib/utils/genotypes.py): the 8-primitive search space, the `MixedOp`
relaxation and `SearchCell` DAG, the genotype decode (the top-2 incoming
edges of a node by their best non-'none' op), the discrete `AugmentCell` /
`AugmentCNN`, and `CDARTSRetrain`, the released retrain network.

Search alphas are not module parameters: `SearchCNN.forward(x,
alphas_normal, alphas_reduce)` takes them, and the searcher owns them
(`nas/cdarts.py`), as in the JAX package.

Conventions (those of the port's other CNNs): NHWC maps at every public
forward; params float32, compute in the model's `dtype`; BatchNorm on the
batch's statistics in train mode (flax's momentum 0.9, biased variance),
on its running statistics in eval mode. The JAX package's rounding points
under bf16: a `MixedOp` weighs each op's output in fp32 (its weights are the
fp32 softmax), so a search cell's nodes and output are fp32 and each conv
casts its input to the compute dtype; a discrete cell's maps stay in the
compute dtype.

As in the JAX package, every BatchNorm of the conv ops is affine, the search
cells' too (the reference builds its search ops with `affine=False`; ROADMAP
Queue 3), and the pools are bare (no BN). `SepConv`'s depthwise 3x3 convs go
through `nn.layers.conv_nchw`: `set_dw_kernel(model, "fused")` sends the
stride-1 ones to K7 and the stride-2 ones to K9, `"wgrad"` the stride-1
ones to K8; `"library"` (the default) keeps cuDNN. The 5x5 and dilated
convs stay on cuDNN.

Parameter names are those of the reference, which
`cream_tpu.zoo.import_torch.convert_cdarts_retrain` reads for the retrain
network: `StdConv.net.{1,2}`, `FactorizedReduce.{conv1,conv2,bn}`,
`SepConv.net.{0,1}.net.{1,2,3}`, `DilConv.net.{1,2,3}`; a search cell's
`preproc{0,1}` and `dag.{node}.{edge}._ops.{primitive}`; a discrete cell's
`dag.{node}.{edge}.0.…` (the `.0` of the reference's `Sequential(op,
DropPath_)`; the port, as the JAX package, draws no drop path); the search
and augment networks' `stem.{0,1}`, `cells.{i}`, `linear`; the retrain
network's `feature_extractor.{j}.{idx}`, `nas_layers.{group}.{cell}` and
`fc`.
"""
from __future__ import annotations

import copy
from typing import NamedTuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from cream_tpu_torch.models.registry import register_model
from cream_tpu_torch.nn.layers import _check_dw_kernel, batch_norm, conv_nchw, linear

PRIMITIVES = ("max_pool_3x3", "avg_pool_3x3", "skip_connect", "sep_conv_3x3",
              "sep_conv_5x5", "dil_conv_3x3", "dil_conv_5x5", "none")
MOMENTUM = 0.9        # flax's BN momentum (the weight of the old value)


class Genotype(NamedTuple):
    normal: list
    normal_concat: list
    reduce: list
    reduce_concat: list


def wide(t: torch.Tensor) -> torch.Tensor:
    """t in fp32, or as it is where it is wider (a float64 run's)."""
    return t if t.dtype == torch.float64 else t.float()


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 2, 3, 1)


def avg_pool(x: torch.Tensor, kernel: int, stride: int, padding: int = 0,
             count_include_pad: bool = True) -> torch.Tensor:
    """`F.avg_pool2d` of the NHWC map x, NHWC out, run on a contiguous NCHW
    copy: on the card (torch 2.11, CUDA 12.8) its backward on a
    channels_last input gives a wrong input grad (49-84% of its largest off,
    fp32 and float64; forward and max pooling are right), and a DARTS
    search network's alpha grads came out 10-17% off."""
    return _nhwc(F.avg_pool2d(_nchw(x).contiguous(), kernel, stride, padding,
                              count_include_pad=count_include_pad))


def _bn(c: int, device, affine: bool = True) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-5, affine=affine, device=device)


def _conv(cin: int, cout: int, k: int = 1, stride: int = 1, padding: int = 0,
          dilation: int = 1, groups: int = 1, device=None) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, padding, dilation, groups, bias=False,
                     device=device)


def conv_bn(conv: nn.Conv2d, bn: nn.BatchNorm2d, x: torch.Tensor, training: bool,
            dtype: torch.dtype) -> torch.Tensor:
    """A library conv then BatchNorm on the NHWC map x, in `dtype`; NHWC out."""
    y = conv_nchw(conv, x.to(dtype), conv.stride[0], conv.padding[0], conv.groups)
    return _nhwc(batch_norm(bn, y, training, MOMENTUM))


class StdConv(nn.Module):
    """ReLU - 1x1 Conv - BN (`net.{1,2}`)."""

    def __init__(self, C_in: int, C_out: int, *, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.net = nn.Sequential(nn.ReLU(), _conv(C_in, C_out, device=device),
                                 _bn(C_out, device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_bn(self.net[1], self.net[2], F.relu(x), self.training, self.dtype)


class FactorizedReduce(nn.Module):
    """ReLU, two stride-2 1x1 convs, the second on the map shifted by one
    pixel (`x[:, 1:, 1:]`), concatenated, BN."""

    def __init__(self, C_in: int, C_out: int, *, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.conv1 = _conv(C_in, C_out // 2, 1, 2, device=device)
        self.conv2 = _conv(C_in, C_out - C_out // 2, 1, 2, device=device)
        self.bn = _bn(C_out, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(x).to(self.dtype)
        # a 1x1 conv at stride 2 is a 1x1 conv of the map's even (and, for
        # the shifted half, odd) pixels; written so, as the CPU backward of a
        # strided 1x1 conv on channels_last maps crashes (torch 2.13)
        a = F.conv2d(_nchw(x[:, ::2, ::2]), self.conv1.weight.to(x.dtype))
        b = F.conv2d(_nchw(x[:, 1::2, 1::2]), self.conv2.weight.to(x.dtype))
        return _nhwc(batch_norm(self.bn, torch.cat([a, b], 1), self.training, MOMENTUM))


class DilConv(nn.Module):
    """ReLU - depthwise kxk Conv (dilation d) - pointwise Conv - BN
    (`net.{1,2,3}`). A 3x3 one of dilation 1 is a depthwise site of the
    kernels (`dw_kernel`)."""

    def __init__(self, C: int, kernel: int, stride: int, dilation: int = 2, *,
                 dtype: torch.dtype = torch.float32, dw_kernel: str = "library", device=None):
        super().__init__()
        _check_dw_kernel(dw_kernel)
        self.dtype, self.dw_kernel = dtype, dw_kernel
        p = dilation * (kernel // 2)
        self.net = nn.Sequential(nn.ReLU(), _conv(C, C, kernel, stride, p, dilation, C, device),
                                 _conv(C, C, device=device), _bn(C, device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dw, pw, bn = self.net[1], self.net[2], self.net[3]
        x = F.relu(x).to(self.dtype)
        if dw.dilation == (1, 1):
            y = conv_nchw(dw, x, dw.stride[0], dw.padding[0], dw.groups, self.dw_kernel)
        else:
            y = F.conv2d(_nchw(x), dw.weight.to(x.dtype), None, dw.stride, dw.padding,
                         dw.dilation, dw.groups)
        y = F.conv2d(y, pw.weight.to(y.dtype))
        return _nhwc(batch_norm(bn, y, self.training, MOMENTUM))


class SepConv(nn.Module):
    """(ReLU - depthwise Conv - pointwise Conv - BN) twice, the first at the
    op's stride: two `DilConv`s of dilation 1 (`net.{0,1}`)."""

    def __init__(self, C: int, kernel: int, stride: int, *, dtype: torch.dtype = torch.float32,
                 dw_kernel: str = "library", device=None):
        super().__init__()
        kw = dict(dtype=dtype, dw_kernel=dw_kernel, device=device)
        self.kernel, self.stride = kernel, stride
        self.net = nn.Sequential(DilConv(C, kernel, stride, 1, **kw), DilConv(C, kernel, 1, 1, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net[1](self.net[0](x))


class Pool(nn.Module):
    """A bare 3x3 pad-1 pool: max (padding counts as -inf) or average over
    the in-map taps only (`count_include_pad=False`)."""

    def __init__(self, mode: str, stride: int):
        super().__init__()
        self.mode, self.stride = mode, stride

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "max":
            return _nhwc(F.max_pool2d(_nchw(x), 3, self.stride, 1))
        return avg_pool(x, 3, self.stride, 1, count_include_pad=False)


class PoolBN(nn.Module):
    """A pool then a BN without scale or bias (`bn`); kept as the JAX package
    keeps it, though no op of the search space builds it."""

    def __init__(self, mode: str, C: int, stride: int, *, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.pool = Pool(mode, stride)
        self.bn = _bn(C, device, affine=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = batch_norm(self.bn, _nchw(self.pool(x)), self.training, MOMENTUM)
        return _nhwc(y.to(self.dtype))


class Zero(nn.Module):
    """The 'none' op: zeros of the output's shape."""

    def __init__(self, stride: int):
        super().__init__()
        self.stride = stride

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _zero(x, self.stride)


def _zero(x: torch.Tensor, stride: int) -> torch.Tensor:
    return torch.zeros_like(x if stride == 1 else x[:, ::stride, ::stride])


def make_op(name: str, C: int, stride: int, *, dtype: torch.dtype = torch.float32,
            dw_kernel: str = "library", device=None) -> nn.Module:
    """The module of primitive `name` at width C and `stride`. The pools are
    bare, as CDARTS builds them (its released retrain checkpoints hold no
    pool BN)."""
    kw = dict(dtype=dtype, dw_kernel=dw_kernel, device=device)
    if name == "none":
        return Zero(stride)
    if name == "skip_connect":
        return nn.Identity() if stride == 1 else FactorizedReduce(C, C, dtype=dtype,
                                                                  device=device)
    if name in ("max_pool_3x3", "avg_pool_3x3"):
        return Pool(name[:3], stride)
    if name.startswith("sep_conv_"):
        return SepConv(C, int(name[-1]), stride, **kw)
    if name.startswith("dil_conv_"):
        return DilConv(C, int(name[-1]), stride, 2, **kw)
    raise ValueError(name)


class MixedOp(nn.Module):
    """The continuous relaxation: the fp32 softmax-weighted sum of every
    primitive's output (`_ops`, `PRIMITIVES` order). The 'none' term, a
    weighted zero, is left out of the sum: it adds nothing and its alpha's
    grad is 0 either way."""

    def __init__(self, C: int, stride: int, *, dtype: torch.dtype = torch.float32,
                 dw_kernel: str = "library", device=None):
        super().__init__()
        self.stride = stride
        self._ops = nn.ModuleList(make_op(p, C, stride, dtype=dtype, dw_kernel=dw_kernel,
                                          device=device) for p in PRIMITIVES)

    def forward(self, x: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
        out = None
        for i, op in enumerate(self._ops):
            if isinstance(op, Zero):
                continue
            term = weights[i] * wide(op(x))
            out = term if out is None else out + term
        return out


class SearchCell(nn.Module):
    """The search DAG: two inputs (`preproc0`, a FactorizedReduce after a
    reduction cell, and `preproc1`) and `n_nodes` nodes, each the sum over
    its incoming edges of `w_edge[e] * MixedOp_e(state)` (`dag.{node}.{j}`);
    the output concatenates the nodes."""

    def __init__(self, n_nodes: int, C_pp: int, C_p: int, C: int, reduction_p: bool,
                 reduction: bool, *, dtype: torch.dtype = torch.float32,
                 dw_kernel: str = "library", device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.reduction = reduction
        self.preproc0 = (FactorizedReduce(C_pp, C, **kw) if reduction_p
                         else StdConv(C_pp, C, **kw))
        self.preproc1 = StdConv(C_p, C, **kw)
        self.dag = nn.ModuleList(
            nn.ModuleList(MixedOp(C, 2 if reduction and j < 2 else 1, dw_kernel=dw_kernel, **kw)
                          for j in range(2 + i)) for i in range(n_nodes))

    def forward(self, s0: torch.Tensor, s1: torch.Tensor, w_dag: torch.Tensor,
                w_edge: torch.Tensor | None = None) -> torch.Tensor:
        """w_dag: (edges, primitives) op weights; w_edge: (edges,) edge
        weights, or None for weights of 1 (the search network's)."""
        states = [self.preproc0(s0), self.preproc1(s1)]
        offset = 0
        for edges in self.dag:
            cur = None
            for j, (op, s) in enumerate(zip(edges, states)):
                y = op(s, w_dag[offset + j])
                if w_edge is not None:
                    y = w_edge[offset + j] * y
                cur = y if cur is None else cur + y
            states.append(cur)
            offset += len(states) - 1
        return torch.cat(states[2:], dim=-1)


def _stem(C_out: int, device) -> nn.Sequential:
    return nn.Sequential(_conv(3, C_out, 3, 1, 1, device=device), _bn(C_out, device))


class SearchCNN(nn.Module):
    """The stem, `n_layers` search cells with reductions at 1/3 and 2/3 of
    the depth, the mean over the map and `linear`. `forward(x,
    alphas_normal, alphas_reduce)`: (edges, primitives) logits, softmaxed
    over the ops in fp32."""

    def __init__(self, num_classes: int = 10, C: int = 16, n_layers: int = 8, n_nodes: int = 4,
                 stem_multiplier: int = 3, img_size: int = 32, *,
                 dtype: torch.dtype = torch.float32, dw_kernel: str = "library", device=None):
        super().__init__()
        self.dtype, self.img_size, self.n_nodes = dtype, img_size, n_nodes
        self.num_classes = num_classes
        C_cur = C * stem_multiplier
        self.stem = _stem(C_cur, device)
        C_pp, C_p, C_cur = C_cur, C_cur, C
        red_p, cells = False, []
        for li in range(n_layers):
            reduction = li in (n_layers // 3, 2 * n_layers // 3)
            if reduction:
                C_cur *= 2
            cells.append(SearchCell(n_nodes, C_pp, C_p, C_cur, red_p, reduction, dtype=dtype,
                                    dw_kernel=dw_kernel, device=device))
            red_p = reduction
            C_pp, C_p = C_p, C_cur * n_nodes
        self.cells = nn.ModuleList(cells)
        self.linear = nn.Linear(C_p, num_classes, device=device)

    def forward(self, x: torch.Tensor, alphas_normal: torch.Tensor,
                alphas_reduce: torch.Tensor) -> torch.Tensor:
        w_normal = torch.softmax(wide(alphas_normal), -1)
        w_reduce = torch.softmax(wide(alphas_reduce), -1)
        s0 = s1 = conv_bn(self.stem[0], self.stem[1], x, self.training, self.dtype)
        for cell in self.cells:
            s0, s1 = s1, cell(s0, s1, w_reduce if cell.reduction else w_normal)
        return linear(self.linear, s1.mean(dim=(1, 2)).to(self.dtype), self.dtype)


def n_alpha_edges(n_nodes: int = 4) -> int:
    return sum(2 + i for i in range(n_nodes))


def init_alphas(generator: torch.Generator, n_nodes: int = 4, device=None) -> dict:
    """{'normal', 'reduce'}: (edges, primitives) fp32 logits 1e-3·N(0, 1)
    from `generator` (the JAX package draws them from its key)."""
    e = n_alpha_edges(n_nodes)
    return {k: 1e-3 * torch.randn(e, len(PRIMITIVES), generator=generator, device=device)
            for k in ("normal", "reduce")}


def softmax_np(a, axis: int = -1) -> np.ndarray:
    """fp32 softmax of `a` as a numpy array (the genotype parses' weights)."""
    return torch.softmax(torch.as_tensor(np.asarray(a, np.float32)), axis).numpy()


def _as_numpy(a) -> np.ndarray:
    return a.detach().float().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def parse_genotype(alphas: dict, n_nodes: int | None = None) -> Genotype:
    """Discretize: per node the top-2 incoming edges by their best non-'none'
    op weight (genotypes.py parse), on the same numpy calls as the JAX
    package's. `n_nodes` is inferred from the edge count (e = n(n+3)/2)
    when not given."""
    if n_nodes is None:
        e = _as_numpy(alphas["normal"]).shape[0]
        n_nodes = int((-3 + (9 + 8 * e) ** 0.5) / 2)
        assert n_alpha_edges(n_nodes) == e, (e, n_nodes)
    none_idx = PRIMITIVES.index("none")

    def parse_one(a):
        w = softmax_np(_as_numpy(a))
        gene, offset = [], 0
        for i in range(n_nodes):
            rows = w[offset:offset + 2 + i].copy()
            rows[:, none_idx] = -1
            best_op = rows.argmax(-1)
            top2 = np.argsort(-rows.max(-1))[:2]
            gene.append([(PRIMITIVES[best_op[j]], int(j)) for j in sorted(top2)])
            offset += 2 + i
        return gene

    concat = list(range(2, 2 + n_nodes))
    return Genotype(parse_one(alphas["normal"]), concat, parse_one(alphas["reduce"]), concat)


class AugmentCell(nn.Module):
    """A discrete cell from a genotype's gene: node i sums its two chosen
    ops (`dag.{i}.{e}`, each but the identity inside a one-module
    Sequential), the output concatenates the `concat` states."""

    def __init__(self, gene, concat, C_pp: int, C_p: int, C: int, reduction_p: bool,
                 reduction: bool, *, dtype: torch.dtype = torch.float32,
                 dw_kernel: str = "library", device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.gene = tuple(tuple((str(op), int(s)) for op, s in edges) for edges in gene)
        self.concat = tuple(int(c) for c in concat)
        self.reduction = reduction
        self.preproc0 = (FactorizedReduce(C_pp, C, **kw) if reduction_p
                         else StdConv(C_pp, C, **kw))
        self.preproc1 = StdConv(C_p, C, **kw)
        self.dag = nn.ModuleList()
        for edges in self.gene:
            row = nn.ModuleList()
            for op_name, s_idx in edges:
                op = make_op(op_name, C, 2 if reduction and s_idx < 2 else 1,
                             dw_kernel=dw_kernel, **kw)
                row.append(op if isinstance(op, nn.Identity) else nn.Sequential(op))
            self.dag.append(row)

    def forward(self, s0: torch.Tensor, s1: torch.Tensor) -> torch.Tensor:
        states = [self.preproc0(s0), self.preproc1(s1)]
        for edges, ops in zip(self.gene, self.dag):
            cur = None
            for (_, s_idx), op in zip(edges, ops):
                y = op(states[s_idx])
                cur = y if cur is None else cur + y
            states.append(cur)
        return torch.cat([states[i] for i in self.concat], dim=-1)


def _genes(g: Genotype, reduction: bool):
    return (g.reduce, g.reduce_concat) if reduction else (g.normal, g.normal_concat)


class AugmentCNN(nn.Module):
    """The retrain network of one genotype (model_augment.py): the stem,
    `n_layers` discrete cells with reductions at 1/3 and 2/3 of the depth,
    the mean over the map and `linear`."""

    def __init__(self, genotype: Genotype, num_classes: int = 10, C: int = 36,
                 n_layers: int = 20, stem_multiplier: int = 3, img_size: int = 32, *,
                 dtype: torch.dtype = torch.float32, dw_kernel: str = "library", device=None):
        super().__init__()
        self.genotype = as_genotype(genotype)
        self.dtype, self.img_size, self.num_classes = dtype, img_size, num_classes
        C_cur = C * stem_multiplier
        self.stem = _stem(C_cur, device)
        C_pp, C_p, C_cur = C_cur, C_cur, C
        red_p, cells = False, []
        for li in range(n_layers):
            reduction = li in (n_layers // 3, 2 * n_layers // 3)
            if reduction:
                C_cur *= 2
            gene, concat = _genes(self.genotype, reduction)
            cells.append(AugmentCell(gene, concat, C_pp, C_p, C_cur, red_p, reduction,
                                     dtype=dtype, dw_kernel=dw_kernel, device=device))
            red_p = reduction
            C_pp, C_p = C_p, C_cur * len(concat)
        self.cells = nn.ModuleList(cells)
        self.linear = nn.Linear(C_p, num_classes, device=device)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None
                ) -> torch.Tensor:
        """`generator`: taken for the train step's interface; no op draws."""
        s0 = s1 = conv_bn(self.stem[0], self.stem[1], x, self.training, self.dtype)
        for cell in self.cells:
            s0, s1 = s1, cell(s0, s1)
        return linear(self.linear, s1.mean(dim=(1, 2)).to(self.dtype), self.dtype)


def genotype_from_str(s: str) -> Genotype:
    """Parse a genotype repr string (CDARTS/lib/utils/genotypes.py from_str;
    the cell_file JSONs store these), evaluated in a namespace holding only
    `Genotype` and `range`."""
    g = eval(s, {"__builtins__": {}, "Genotype": Genotype, "range": range})
    return as_genotype(g)


def as_genotype(g) -> Genotype:
    """A Genotype with lists of (op, input) tuples, from a Genotype, its
    repr string or its `_asdict()` as JSON reads it back."""
    if isinstance(g, str):
        return genotype_from_str(g)
    if isinstance(g, dict):
        g = Genotype(**g)
    return Genotype(normal=[[(str(op), int(s)) for op, s in e] for e in g.normal],
                    normal_concat=[int(c) for c in g.normal_concat],
                    reduce=[[(str(op), int(s)) for op, s in e] for e in g.reduce],
                    reduce_concat=[int(c) for c in g.reduce_concat])


def as_genotypes(genotypes) -> tuple:
    """Per-group genotypes from the cell_file dict ({"0": str, ...}, in the
    order of its integer keys) or a sequence of Genotypes, repr strings or
    JSON dicts (`cli.search_cdarts`'s `final_genotypes`)."""
    if isinstance(genotypes, dict):
        genotypes = [genotypes[k] for k in sorted(genotypes, key=int)]
    return tuple(as_genotype(g) for g in genotypes)


def cdarts_retrain_plan(model_type: str, res_stem: bool):
    """(layers_reduction, augment_layers, initial reduction_p) as ModelTest
    sets them (lib/models/model_test.py:20-40)."""
    if model_type == "cifar":
        return [True, True, False], [7, 7, 6], False
    if model_type == "imagenet":
        if res_stem:
            return [False, True, True, True], [3, 4, 3, 4], False
        return [True, True, False], [5, 5, 4], True
    raise ValueError(model_type)


class CDARTSRetrain(nn.Module):
    """The CDARTS retrain / eval network, the reference's ModelTest: a
    cifar, imagenet or resnet stem (`feature_extractor`), then groups of
    discrete cells (`nas_layers.{group}.{cell}`) from one genotype a group,
    the group's reduction cell last (first with `res_stem`), the mean over
    the map and `fc`."""

    def __init__(self, genotypes, model_type: str = "imagenet", res_stem: bool = False,
                 init_channels: int = 48, stem_multiplier: int = 3, num_classes: int = 1000,
                 img_size: int | None = None, *, dtype: torch.dtype = torch.float32,
                 dw_kernel: str = "library", device=None):
        super().__init__()
        self.genotypes = as_genotypes(genotypes)
        self.model_type, self.res_stem, self.dtype = model_type, res_stem, dtype
        self.num_classes = num_classes
        self.img_size = img_size or (32 if model_type == "cifar" else 224)
        reductions, cell_nums, reduction_p = cdarts_retrain_plan(model_type, res_stem)
        C0 = init_channels * stem_multiplier
        if model_type == "cifar":
            stems = [nn.Sequential(_conv(3, C0, 3, 1, 1, device=device), _bn(C0, device))]
        elif res_stem:
            stems = [nn.Sequential(_conv(3, C0, 7, 2, 3, device=device), _bn(C0, device),
                                   nn.ReLU(), nn.MaxPool2d(3, 2, 1))]
        else:
            stems = [nn.Sequential(_conv(3, C0 // 2, 3, 2, 1, device=device),
                                   _bn(C0 // 2, device), nn.ReLU(),
                                   _conv(C0 // 2, C0, 3, 2, 1, device=device), _bn(C0, device)),
                     nn.Sequential(nn.ReLU(), _conv(C0, C0, 3, 2, 1, device=device),
                                   _bn(C0, device))]
        self.feature_extractor = nn.ModuleList(stems)
        C_pp = C_p = C0
        c_cur = init_channels
        self.nas_layers = nn.ModuleList()
        for li, genotype in enumerate(self.genotypes):
            cells = nn.ModuleList()
            reduction_idx = 0 if res_stem else cell_nums[li] - 1
            C = c_cur
            for i in range(cell_nums[li]):
                reduction = i == reduction_idx and reductions[li]
                if reduction:
                    C *= 2
                gene, concat = _genes(genotype, reduction)
                cells.append(AugmentCell(gene, concat, C_pp, C_p, C, reduction_p, reduction,
                                         dtype=dtype, dw_kernel=dw_kernel, device=device))
                reduction_p = reduction
                C_pp, C_p = C_p, C * len(concat)
            if reductions[li]:
                c_cur *= 2
            if res_stem:
                reduction_p = False
            self.nas_layers.append(cells)
        self.fc = nn.Linear(C_p, num_classes, device=device)

    def _stems(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        fe, tr, dt = self.feature_extractor, self.training, self.dtype
        if self.model_type == "cifar":
            s = conv_bn(fe[0][0], fe[0][1], x, tr, dt)
            return s, s
        if self.res_stem:
            h = F.relu(conv_bn(fe[0][0], fe[0][1], x, tr, dt))
            s = _nhwc(F.max_pool2d(_nchw(h), 3, 2, 1))
            return s, s
        h = F.relu(conv_bn(fe[0][0], fe[0][1], x, tr, dt))
        s0 = conv_bn(fe[0][3], fe[0][4], h, tr, dt)
        return s0, conv_bn(fe[1][1], fe[1][2], F.relu(s0), tr, dt)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None, *,
                pyramid: bool = False):
        """`generator`: taken for the train step's interface (the reference's
        drop path on the ops is not drawn, as in the JAX package)."""
        s0, s1 = self._stems(x)
        feats = [s1]
        for cells in self.nas_layers:
            for cell in cells:
                s0, s1 = s1, cell(s0, s1)
            feats.append(s1)
        if pyramid:
            # the last feature at each of the three largest distinct strides
            by_size = {f.shape[1]: f for f in feats}
            return tuple(by_size[s] for s in sorted(by_size, reverse=True)[:3])
        return linear(self.fc, s1.mean(dim=(1, 2)).to(self.dtype), self.dtype)

    def forward_pyramid(self, x: torch.Tensor) -> tuple:
        """The three coarsest-stride NHWC features, for detection necks (the
        CDARTS_detection backbone contract)."""
        return self(x, pyramid=True)


def dw3x3_path_sites(model: nn.Module) -> tuple[int, int]:
    """(stride-1, stride-2) depthwise 3x3 sites one forward of a search,
    augment or retrain network runs: K7's and K9's launches a forward on
    `"fused"`. Each 3x3 SepConv is two sites, its first at the op's stride
    and its second at stride 1."""
    s1 = s2 = 0
    for m in model.modules():
        if isinstance(m, SepConv) and m.kernel == 3:
            s1 += 1 + (m.stride == 1)
            s2 += m.stride == 2
    return s1, s2


def dw3x3_step_launches(model: SearchCNN, alpha_step: bool = False) -> dict:
    """K7/K9 launches of one search step of a `SearchCNN` on `"fused"`
    (`dwconv.LAUNCHES`' keys): every 3x3 SepConv site forward once; backward
    once where the step's grads reach it: every site in a weight step; in an
    alpha step only the sites whose input depends on the alphas (autograd
    runs no other backward): an op on a cell's intermediate node, on its
    second input from the second cell on, on its first from the third."""
    out = dict.fromkeys(("k7_fwd", "k7_bwd", "k8", "k9_fwd", "k9_bwd"), 0)
    for li, cell in enumerate(model.cells):
        for edges in cell.dag:
            for j, mixed in enumerate(edges):
                sep = mixed._ops[PRIMITIVES.index("sep_conv_3x3")]
                s1, s2 = 1 + (sep.stride == 1), int(sep.stride == 2)
                back = not alpha_step or j >= 2 or (j == 1 and li >= 1) or (j == 0 and li >= 2)
                out["k7_fwd"] += s1
                out["k9_fwd"] += s2
                if back:
                    out["k7_bwd"] += s1
                    out["k9_bwd"] += s2
    return out


@torch.no_grad()
def dw3x3_sites(model: nn.Module, batch: int, *args) -> list[tuple[int, tuple[int, ...]]]:
    """(stride, NHWC input shape) of each depthwise 3x3 site one forward of
    `model` at `batch` reaches, in order, duplicates dropped: the shapes K7
    (stride 1) and K9 (stride 2) take on `"fused"`. Traced on the meta
    device (no data, no kernel); `args` are the forward's other inputs (a
    search network's alphas)."""
    meta = copy.deepcopy(model).to("meta").eval()
    sites = []

    def hook(mod, inputs):
        dw = mod.net[1]
        site = (dw.stride[0], tuple(inputs[0].shape))
        if site not in sites:
            sites.append(site)
    for m in meta.modules():
        if isinstance(m, DilConv) and m.net[1].dilation == (1, 1) and m.net[1].kernel_size == (3, 3):
            m.register_forward_pre_hook(hook)
    meta(torch.zeros(batch, model.img_size, model.img_size, 3, device="meta"),
         *(a.to("meta") for a in args))
    return sites


# a genotype that holds every primitive but 'none' in both cell types, with
# stride-2 edges in the reduce cell (the smoke's and the tests' retrain
# networks; not a searched one)
EXAMPLE_GENOTYPE = Genotype(
    normal=[[("sep_conv_3x3", 0), ("sep_conv_5x5", 1)],
            [("dil_conv_3x3", 0), ("skip_connect", 1)],
            [("max_pool_3x3", 1), ("dil_conv_5x5", 2)],
            [("avg_pool_3x3", 0), ("sep_conv_3x3", 3)]],
    normal_concat=[2, 3, 4, 5],
    reduce=[[("max_pool_3x3", 0), ("sep_conv_3x3", 1)],
            [("skip_connect", 0), ("avg_pool_3x3", 2)],
            [("dil_conv_5x5", 1), ("sep_conv_5x5", 2)],
            [("dil_conv_3x3", 0), ("skip_connect", 3)]],
    reduce_concat=[2, 3, 4, 5])


@register_model
def cdarts_retrain_imagenet(genotypes, num_classes: int = 1000, init_channels: int = 48,
                            res_stem: bool = False, *, device, dtype=torch.float32, **kw):
    """genotypes: one Genotype a group, or the cell_file dict or strings."""
    return CDARTSRetrain(genotypes, "imagenet", res_stem, init_channels,
                         num_classes=num_classes, dtype=dtype, device=device, **kw)


@register_model
def cdarts_retrain_cifar(genotypes, num_classes: int = 10, init_channels: int = 36, *,
                         device, dtype=torch.float32, **kw):
    return CDARTSRetrain(genotypes, "cifar", False, init_channels, num_classes=num_classes,
                         dtype=dtype, device=device, **kw)


@register_model
def darts_search_cifar(num_classes: int = 10, *, device, dtype=torch.float32, **kw):
    return SearchCNN(num_classes=num_classes, dtype=dtype, device=device, **kw)


@register_model
def darts_augment_cifar(genotype, num_classes: int = 10, *, device, dtype=torch.float32, **kw):
    return AugmentCNN(genotype, num_classes=num_classes, dtype=dtype, device=device, **kw)
