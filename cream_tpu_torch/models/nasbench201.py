"""The NAS-Bench-201 search space (CDARTS/benchmark201).

Counterpart of `cream_tpu/models/nasbench201.py` (CDARTS/benchmark201/
models/{ops.py,search_cells.py,cdarts_controller.py} and utils/genotypes.py
Structure). The 201 cell is a 4-node DAG whose every edge i<-j (6 edges in
the lexicographic order '1<-0', '2<-0', '2<-1', '3<-0', '3<-1', '3<-2')
carries one of 5 ops; the skeleton is stem -> N cells -> ResNetBasicblock
(stride 2) -> N cells -> ResNetBasicblock -> N cells -> BN, ReLU -> the mean
over the map -> classifier, with ONE (6, 5) alpha matrix shared by all
cells. The search network keeps the DARTS networks' `forward(x,
alphas_normal, alphas_reduce)`, so `nas/cdarts.py`'s searcher drives it
unchanged; 201 ignores the reduce set.

NHWC maps, params float32, compute in the model's `dtype`; a search cell
weighs its ops in fp32, as `models.darts.MixedOp`. Its `avg_pool_3x3`
counts the padding (`count_include_pad=True`), unlike DARTS'. The cells'
ReLUConvBN ops have no BN scale or bias (`affine=False`); the stem, the
ResNet blocks and the last BN have them.

Parameter names are AutoDL's (the reference's TinyNetwork): `stem.{0,1}`,
`cells.{k}` (the cells and the two ResNet blocks in order), a search cell's
`edges.{i<-j}.{op}.op.{1,2}`, an infer cell's `layers.{k}.op.{1,2}`, a
block's `conv_a`, `conv_b`, `downsample.1`, `lastact.0` and `classifier`.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from cream_tpu_torch.models.darts import (_as_numpy, _bn, _conv, _nchw, _nhwc, avg_pool, conv_bn,
                                          wide)
from cream_tpu_torch.models.registry import register_model
from cream_tpu_torch.nn.layers import batch_norm, linear

NB201_OPS = ("none", "skip_connect", "nor_conv_1x1", "nor_conv_3x3", "avg_pool_3x3")
EDGES = tuple((i, j) for i in range(1, 4) for j in range(i))  # lexicographic
N_EDGES = len(EDGES)                                          # 6
MOMENTUM = 0.9


class ReLUConvBN(nn.Module):
    """ReLU - Conv - BN (`op.{1,2}`), the conv padded by kernel // 2."""

    def __init__(self, C_in: int, C_out: int, kernel: int, stride: int = 1,
                 affine: bool = False, *, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.op = nn.Sequential(nn.ReLU(), _conv(C_in, C_out, kernel, stride, kernel // 2,
                                                 device=device), _bn(C_out, device, affine))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_bn(self.op[1], self.op[2], F.relu(x), self.training, self.dtype)


class ResNetBasicblock(nn.Module):
    """The fixed reduction block between stages: conv_a (3x3 at the stride),
    conv_b (3x3), and a shortcut (a 2x2 average pool and a 1x1 conv at stride
    2, a ReLUConvBN 1x1 where only the width changes)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 2, *,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.dtype, self.stride = dtype, stride
        self.conv_a = ReLUConvBN(inplanes, planes, 3, stride, True, **kw)
        self.conv_b = ReLUConvBN(planes, planes, 3, 1, True, **kw)
        if stride == 2:
            self.downsample = nn.Sequential(nn.AvgPool2d(2, 2), _conv(inplanes, planes,
                                                                      device=device))
        elif inplanes != planes:
            self.downsample = ReLUConvBN(inplanes, planes, 1, 1, True, **kw)
        else:
            self.downsample = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_b(self.conv_a(x))
        if self.stride == 2:
            r = _nchw(avg_pool(x, 2, 2)).to(self.dtype)
            r = _nhwc(F.conv2d(r, self.downsample[1].weight.to(self.dtype)))
        elif self.downsample is not None:
            r = self.downsample(x)
        else:
            r = x
        return r + h


def make_op(op: str, C: int, *, dtype: torch.dtype = torch.float32, device=None) -> nn.Module:
    """The module of a 201 op at width C and stride 1."""
    if op == "none":
        return Zero201()
    if op == "skip_connect":
        return nn.Identity()
    if op == "avg_pool_3x3":
        return nn.AvgPool2d(3, 1, 1, count_include_pad=True)
    k = {"nor_conv_1x1": 1, "nor_conv_3x3": 3, "nor_conv_7x7": 7}[op]
    return ReLUConvBN(C, C, k, 1, dtype=dtype, device=device)


class Zero201(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.zeros_like(x)


def _apply(op: nn.Module, x: torch.Tensor) -> torch.Tensor:
    if isinstance(op, nn.AvgPool2d):           # NHWC in and out
        return avg_pool(x, op.kernel_size, op.stride, op.padding, op.count_include_pad)
    return op(x)


class Cell201(nn.Module):
    """The search cell: node i = sum over j < i and the ops of
    w[edge(i, j), op] * op(node_j) (`edges.{i<-j}.{op}`), in fp32. The
    'none' terms, weighted zeros, are left out of the sum."""

    def __init__(self, C: int, *, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.edges = nn.ModuleDict({
            f"{i}<-{j}": nn.ModuleList(make_op(op, C, dtype=dtype, device=device)
                                       for op in NB201_OPS) for i, j in EDGES})

    def forward(self, x: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
        nodes = [x]
        for i in range(1, 4):
            acc = None
            for j in range(i):
                e = EDGES.index((i, j))
                for oi, op in enumerate(self.edges[f"{i}<-{j}"]):
                    if isinstance(op, Zero201):
                        continue
                    term = weights[e, oi] * wide(_apply(op, nodes[j]))
                    acc = term if acc is None else acc + term
            nodes.append(acc)
        return nodes[-1]


class InferCell201(nn.Module):
    """The discrete cell of a genotype (a tuple over nodes 1..3 of (op,
    input node) tuples): each node sums its ops (`layers.{k}`, in order);
    a node without inputs is zeros."""

    def __init__(self, genotype, C: int, *, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.genotype = tuple(tuple((str(op), int(j)) for op, j in node) for node in genotype)
        self.layers = nn.ModuleList(make_op(op, C, dtype=dtype, device=device)
                                    for node in self.genotype for op, _ in node)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        nodes, k = [x], 0
        for node in self.genotype:
            acc = None
            for _, j in node:
                y = _apply(self.layers[k], nodes[j])
                k += 1
                acc = y if acc is None else acc + y
            nodes.append(torch.zeros_like(nodes[0]) if acc is None else acc)
        return nodes[-1]


class _Network201(nn.Module):
    """The stem, three stages of N cells with a ResNet block between, the
    last BN + ReLU, the mean over the map, the classifier."""

    def __init__(self, make_cell, num_classes: int, C: int, N: int, img_size: int,
                 dtype: torch.dtype, device):
        super().__init__()
        self.dtype, self.img_size, self.num_classes = dtype, img_size, num_classes
        self.stem = nn.Sequential(_conv(3, C, 3, 1, 1, device=device), _bn(C, device))
        cells, c = [], C
        for stage in range(3):
            if stage > 0:
                cells.append(ResNetBasicblock(c, 2 * c, 2, dtype=dtype, device=device))
                c *= 2
            cells.extend(make_cell(c) for _ in range(N))
        self.cells = nn.ModuleList(cells)
        self.lastact = nn.Sequential(_bn(c, device), nn.ReLU())
        self.classifier = nn.Linear(c, num_classes, device=device)

    def _run(self, x: torch.Tensor, cell_fn) -> torch.Tensor:
        x = conv_bn(self.stem[0], self.stem[1], x, self.training, self.dtype)
        for cell in self.cells:
            x = cell(x) if isinstance(cell, ResNetBasicblock) else cell_fn(cell, x)
        # flax normalizes the cell's (fp32) output and rounds the result
        y = batch_norm(self.lastact[0], _nchw(x), self.training, MOMENTUM).to(self.dtype)
        x = F.relu(_nhwc(y)).mean(dim=(1, 2))
        return linear(self.classifier, x.to(self.dtype), self.dtype)


class TinyNetwork201(_Network201):
    """The search network: one (6, 5) alpha matrix for every cell;
    `forward(x, alphas_normal, alphas_reduce=None)`, the reduce set
    accepted and ignored."""

    def __init__(self, num_classes: int = 10, C: int = 16, N: int = 5, img_size: int = 32, *,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__(lambda c: Cell201(c, dtype=dtype, device=device), num_classes, C, N,
                         img_size, dtype, device)

    def forward(self, x: torch.Tensor, alphas_normal: torch.Tensor,
                alphas_reduce: torch.Tensor | None = None) -> torch.Tensor:
        w = torch.softmax(wide(alphas_normal), -1)
        return self._run(x, lambda cell, h: cell(h, w))


class TinyNetwork201Infer(_Network201):
    """The evaluation / retrain network of a discretized genotype."""

    def __init__(self, genotype, num_classes: int = 10, C: int = 16, N: int = 5,
                 img_size: int = 32, *, dtype: torch.dtype = torch.float32, device=None):
        if isinstance(genotype, str):
            genotype = structure_fromstr(genotype)
        self.genotype = tuple(tuple((str(op), int(j)) for op, j in node) for node in genotype)
        super().__init__(lambda c: InferCell201(self.genotype, c, dtype=dtype, device=device),
                         num_classes, C, N, img_size, dtype, device)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None
                ) -> torch.Tensor:
        """`generator`: taken for the train step's interface; no op draws."""
        return self._run(x, lambda cell, h: cell(h))


def init_alphas_201(generator: torch.Generator, scale: float = 1e-3, device=None) -> dict:
    """{'normal': (6, 5) scale·N(0, 1) from `generator`, 'reduce': zeros},
    the reduce set a dummy twin kept for the searcher's interface."""
    a = scale * torch.randn(N_EDGES, len(NB201_OPS), generator=generator, device=device)
    return {"normal": a, "reduce": torch.zeros_like(a)}


def parse_structure(alphas) -> tuple:
    """The argmax op of each edge -> a genotype tuple
    (cdarts_controller.py:332-344)."""
    a = _as_numpy(alphas["normal"] if isinstance(alphas, dict) else alphas)
    return tuple(tuple((NB201_OPS[int(a[EDGES.index((i, j))].argmax())], j) for j in range(i))
                 for i in range(1, 4))


def structure_tostr(genotype) -> str:
    """The canonical NAS-Bench-201 arch string (Structure.tostr):
    '|op~0|+|op~0|op~1|+|op~0|op~1|op~2|'."""
    return "+".join("|" + "|".join(f"{op}~{j}" for op, j in node) + "|" for node in genotype)


def structure_fromstr(xstr: str) -> tuple:
    """Inverse of `structure_tostr` (str2structure)."""
    genotype = []
    for node_str in xstr.split("+"):
        node = []
        for inp in (s for s in node_str.split("|") if s):
            op, j = inp.rsplit("~", 1)
            node.append((op, int(j)))
        genotype.append(tuple(node))
    return tuple(genotype)


def structure_check_valid(genotype) -> bool:
    """Whether the output node is reachable through non-'none' ops
    (Structure.check_valid)."""
    reachable = {0: True}
    for i, node in enumerate(genotype, start=1):
        reachable[i] = any(op != "none" and reachable[j] for op, j in node)
    return reachable[len(genotype)]


# an arch that holds every op of the space (the smoke's and the tests'
# infer network; not a searched one)
EXAMPLE_ARCH = ("|nor_conv_3x3~0|+|skip_connect~0|nor_conv_1x1~1|"
                "+|avg_pool_3x3~0|none~1|nor_conv_3x3~2|")


@register_model
def nasbench201_search(num_classes: int = 10, C: int = 16, N: int = 5, *, device,
                       dtype=torch.float32, **kw):
    return TinyNetwork201(num_classes, C, N, dtype=dtype, device=device, **kw)


@register_model
def nasbench201_infer(genotype, num_classes: int = 10, C: int = 16, N: int = 5, *, device,
                      dtype=torch.float32, **kw):
    return TinyNetwork201Infer(genotype, num_classes, C, N, dtype=dtype, device=device, **kw)
