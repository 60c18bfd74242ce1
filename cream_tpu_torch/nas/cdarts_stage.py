"""The staged CDARTS search: layer-by-layer discretization with super <-> nas
parameter copies and distillation aux heads.

Counterpart of `cream_tpu/nas/cdarts_stage.py` (CDARTS/lib/models/
cdarts_controller.py: the structure, the aux heads :150-163, the forward
:640-710, the parameter copies :314-380, the genotype :598-640; the staged
search of CDARTS/CDARTS/search.py:126-300 and lib/core/search_function.py).

`CDARTSController` is one module holding both the search cells
(`super_layers`) and the discrete cells of the current genotypes
(`nas_layers`) over a shared stem; `super_flag` / `layer_idx` pick the path.
Discretization builds a new controller for the new genotypes, carries every
tensor whose name and shape survive (`transfer_variables`) and copies the
chosen ops' weights from the search cells into the discrete ones
(`copy_super_to_nas`); `copy_nas_to_super` writes them back. The copies are
in-place `copy_`s of params and BN buffers.

The alphas (`normal`, `reduce`: op logits; `beta_normal`, `beta_reduce`:
edge logits softmaxed per node) are a dict of fp32 tensors the searcher
owns, one set shared by every cell of a type. The steps update the model and
the alphas in place; each takes the grads of every param the loss reaches
and zero for the others (as the JAX package's grads over the whole tree),
so momentum moves those too.

Parameter names: `stem.{0,1}`, `super_layers.{l}.{c}` (`models.darts.
SearchCell`), `nas_layers.{l}.{c}` (`AugmentCell`), `distill_aux_head1`,
`distill_aux_head2` (`features.{2,3,5,6}`, `classifier`), `fc_super`,
`fc_nas`, `ensemble_param`.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from cream_tpu_torch.models.darts import (PRIMITIVES, AugmentCell, Genotype, SearchCell,
                                          _as_numpy, _bn, _conv, _nchw, avg_pool, conv_bn,
                                          n_alpha_edges, softmax_np, wide)
from cream_tpu_torch.nn.layers import batch_norm, linear
from cream_tpu_torch.train.losses import interactive_loss
from cream_tpu_torch.train.optim import make_sgd

MOMENTUM = 0.9


class DistillHead(nn.Module):
    """The aux classifier (CDARTS/lib/models/aux_head.py:5-27): ReLU, a
    VALID average pool of `pool_size` at stride 2, 1x1 conv 128 + BN + ReLU,
    2x2 conv 768 + BN + ReLU (BNs without scale or bias), the mean over the
    map, a Linear (`features.{2,3,5,6}`, `classifier`). The 2x2 conv pads
    as the JAX package's flax default 'SAME' does, one row and column after
    the map (the reference's is unpadded; ROADMAP Queue 3)."""

    def __init__(self, C_in: int, pool_size: int, num_classes: int, *,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype, self.pool_size = dtype, pool_size
        self.features = nn.Sequential(
            nn.ReLU(), nn.AvgPool2d(pool_size, 2, 0, count_include_pad=False),
            _conv(C_in, 128, device=device), _bn(128, device, affine=False), nn.ReLU(),
            _conv(128, 768, 2, device=device), _bn(768, device, affine=False), nn.ReLU())
        self.classifier = nn.Linear(768, num_classes, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        f, dt = self.features, self.dtype
        x = _nchw(avg_pool(F.relu(x), self.pool_size, 2)).to(dt)
        x = F.relu(batch_norm(f[3], F.conv2d(x, f[2].weight.to(dt)), self.training, MOMENTUM))
        x = F.conv2d(F.pad(x, (0, 1, 0, 1)), f[5].weight.to(dt))
        x = F.relu(batch_norm(f[6], x, self.training, MOMENTUM))
        return linear(self.classifier, x.mean(dim=(2, 3)), dt)


def _layer_channels(C: int, stem_multiplier: int, layer_num: int, cells_per_layer: int,
                    n_nodes: int):
    """Per layer, per cell: (C_cur, reduction_p, reduction, C_pp, C_p); each
    layer but the last ends with a reduction cell (cdarts_controller.py
    add_super_layer, the res_stem=False branch)."""
    plan = []
    C_pp = C_p = C * stem_multiplier
    C_cur, red_p = C, False
    for li in range(layer_num):
        cells = []
        for ci in range(cells_per_layer):
            reduction = ci == cells_per_layer - 1 and li < layer_num - 1
            if reduction:
                C_cur *= 2
            cells.append((C_cur, red_p, reduction, C_pp, C_p))
            red_p = reduction
            C_pp, C_p = C_p, C_cur * n_nodes
        plan.append(cells)
    return plan


def edge_weights(beta: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """The per-node softmax of the edge logits (process_alpha), fp32."""
    parts, off = [], 0
    for i in range(n_nodes):
        parts.append(torch.softmax(wide(beta[off:off + 2 + i]), -1))
        off += 2 + i
    return torch.cat(parts)


class CDARTSController(nn.Module):
    """The super and nas paths over a shared stem, with the distillation aux
    heads after layers `layer_num - 3` and `layer_num - 2` (those that
    exist). `genotypes`: one Genotype a layer, the nas path's current
    discretization."""

    def __init__(self, genotypes: Sequence[Genotype], num_classes: int = 10,
                 layer_num: int = 3, cells_per_layer: int = 2, n_nodes: int = 4, C: int = 16,
                 stem_multiplier: int = 3, aux_pool_size: int = 6, *,
                 dtype: torch.dtype = torch.float32, dw_kernel: str = "library", device=None):
        super().__init__()
        self.genotypes = tuple(genotypes)
        self.layer_num, self.n_nodes, self.dtype = layer_num, n_nodes, dtype
        self.plan = _layer_channels(C, stem_multiplier, layer_num, cells_per_layer, n_nodes)
        C0 = C * stem_multiplier
        self.stem = nn.Sequential(_conv(3, C0, 3, 1, 1, device=device), _bn(C0, device))
        kw = dict(dtype=dtype, dw_kernel=dw_kernel, device=device)
        self.super_layers = nn.ModuleList()
        self.nas_layers = nn.ModuleList()
        for li, g in enumerate(self.genotypes):
            sup, nas = nn.ModuleList(), nn.ModuleList()
            for C_cur, red_p, red, C_pp, C_p in self.plan[li]:
                sup.append(SearchCell(n_nodes, C_pp, C_p, C_cur, red_p, red, **kw))
                gene, concat = (g.reduce, g.reduce_concat) if red else (g.normal,
                                                                         g.normal_concat)
                nas.append(AugmentCell(gene, concat, C_pp, C_p, C_cur, red_p, red, **kw))
            self.super_layers.append(sup)
            self.nas_layers.append(nas)
        self.aux_layers = {}
        for li, name in ((layer_num - 3, "distill_aux_head1"), (layer_num - 2, "distill_aux_head2")):
            if li >= 0:
                c_out = self.plan[li][-1][0] * n_nodes
                self.add_module(name, DistillHead(c_out, aux_pool_size, num_classes,
                                                  dtype=dtype, device=device))
                self.aux_layers[li] = name
        c_last = self.plan[-1][-1][0] * n_nodes
        self.fc_super = nn.Linear(c_last, num_classes, device=device)
        self.fc_nas = nn.Linear(c_last, num_classes, device=device)
        self.ensemble_param = nn.Parameter(torch.full((3,), 1.0 / 3, device=device))

    def _path(self, x, w_dag, w_edge, layer_idx, super_flag, pretrain):
        s0 = s1 = conv_bn(self.stem[0], self.stem[1], x, self.training, self.dtype)
        outputs, aux_logits = [], None
        for li in range(self.layer_num):
            use_nas = not pretrain and (li < layer_idx if super_flag else True)
            for ci, (_, _, red, _, _) in enumerate(self.plan[li]):
                if use_nas:
                    s0, s1 = s1, self.nas_layers[li][ci](s0, s1)
                else:
                    k = "reduce" if red else "normal"
                    s0, s1 = s1, self.super_layers[li][ci](s0, s1, w_dag[k], w_edge[k])
            if li in self.aux_layers:
                aux_logits = getattr(self, self.aux_layers[li])(s1)
                if not pretrain:
                    outputs.append(aux_logits)
        fc = self.fc_super if super_flag or pretrain else self.fc_nas
        return linear(fc, s1.mean(dim=(1, 2)).to(self.dtype), self.dtype), outputs, aux_logits

    def forward(self, x: torch.Tensor, alphas: dict, layer_idx: int = 0,
                super_flag: bool = True, pretrain: bool = False):
        """(logits, ensemble logits), or (logits, the last aux head's logits)
        when `pretrain` (cdarts_controller.py:640-710)."""
        w_dag = {k: torch.softmax(wide(alphas[k]), -1) for k in ("normal", "reduce")}
        w_edge = {k: edge_weights(alphas["beta_" + k], self.n_nodes)
                  for k in ("normal", "reduce")}
        logits, outputs, aux_logits = self._path(x, w_dag, w_edge, layer_idx, super_flag,
                                                 pretrain)
        if pretrain:
            return logits, aux_logits
        outputs.append(logits)
        w = torch.softmax(self.ensemble_param[:len(outputs)], -1)
        em = w[0] * wide(outputs[0])
        for i in range(1, len(outputs)):
            em = em + w[i] * wide(outputs[i])
        return logits, em


# ---- alphas ----

def init_stage_alphas(generator: torch.Generator, n_nodes: int = 4, device=None) -> dict:
    """Op logits 1e-3·N(0, 1) from `generator` (drawn on its device, then
    moved to `device`), edge logits 0."""
    e = n_alpha_edges(n_nodes)
    gd = generator.device
    out = {k: (1e-3 * torch.randn(e, len(PRIMITIVES), generator=generator, device=gd)).to(device)
           for k in ("normal", "reduce")}
    out.update({f"beta_{k}": torch.zeros(e, device=device) for k in ("normal", "reduce")})
    return out


def parse_stage_genotype(alphas: dict, n_nodes: int = 4) -> Genotype:
    """process_alpha (cdarts_controller.py:711-745): rank a node's edges by
    the max over its ops ('none' out) of edge_softmax(beta) ·
    op_softmax(alpha), on the same numpy calls as the JAX package's."""
    none_idx = PRIMITIVES.index("none")

    def parse_one(a, b):
        aw, b = softmax_np(_as_numpy(a)), _as_numpy(b)
        gene, off = [], 0
        for i in range(n_nodes):
            n_in = 2 + i
            ew = softmax_np(b[off:off + n_in])
            rows = aw[off:off + n_in].copy()
            rows[:, none_idx] = -1.0
            scored = ew[:, None] * rows
            best_op = scored.argmax(-1)
            top2 = np.argsort(-scored.max(-1))[:2]
            gene.append([(PRIMITIVES[best_op[j]], int(j)) for j in sorted(top2)])
            off += n_in
        return gene

    concat = list(range(2, 2 + n_nodes))
    return Genotype(parse_one(alphas["normal"], alphas["beta_normal"]), concat,
                    parse_one(alphas["reduce"], alphas["beta_reduce"]), concat)


# ---- parameter copies ----

def _tensors(m: nn.Module):
    return list(m.named_parameters()) + list(m.named_buffers())


def _chosen_ops(cell: AugmentCell, sup: SearchCell):
    """(nas op, super op) pairs of the cell's gene, the ops without
    parameters or statistics left out."""
    for node, edges in enumerate(cell.gene):
        for e, (op_name, s_idx) in enumerate(edges):
            stride = 2 if cell.reduction and s_idx < 2 else 1
            if op_name == "none" or (op_name == "skip_connect" and stride == 1):
                continue
            src = sup.dag[node][s_idx]._ops[PRIMITIVES.index(op_name)]
            if _tensors(src):
                yield cell.dag[node][e][0], src


@torch.no_grad()
def _copy_layers(model: CDARTSController, layers: Sequence[int], to_nas: bool) -> None:
    for li in layers:
        for nas, sup in zip(model.nas_layers[li], model.super_layers[li]):
            pairs = [(nas.preproc0, sup.preproc0), (nas.preproc1, sup.preproc1),
                     *_chosen_ops(nas, sup)]
            for n, s in pairs:
                (n.load_state_dict(s.state_dict()) if to_nas
                 else s.load_state_dict(n.state_dict()))


def copy_super_to_nas(model: CDARTSController, layers: Sequence[int]) -> None:
    """copy_params_from_super_layer, in place: each nas cell of `layers`
    takes its search cell's preprocessing and, per edge of its gene, the
    chosen op's weights and BN statistics out of the MixedOp on that input."""
    _copy_layers(model, layers, True)


def copy_nas_to_super(model: CDARTSController, layers: Sequence[int]) -> None:
    """copy_params_from_nas_layer, in place: the reverse of
    `copy_super_to_nas`."""
    _copy_layers(model, layers, False)


@torch.no_grad()
def transfer_variables(new: nn.Module, old: nn.Module) -> None:
    """Carry into `new` (in place) every param and buffer of `old` whose
    name, shape and dtype `new` has (a rebuilt controller's surviving
    tensors)."""
    old_sd = old.state_dict()
    for name, t in new.state_dict().items():
        o = old_sd.get(name)
        if o is not None and o.shape == t.shape and o.dtype == t.dtype:
            t.copy_(o)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """A fresh draw of every weight of `model` from `generator`, at flax's
    scales: conv and Linear weights N(0, 1/fan_in) (lecun's variance,
    untruncated), their biases 0, BN scales 1 and biases 0, running means 0
    and variances 1, the ensemble weights 1/3."""
    for name, t in model.state_dict().items():
        if name.endswith("num_batches_tracked") or name.endswith("running_mean"):
            t.zero_()
        elif name.endswith("running_var"):
            t.fill_(1.0)
        elif name == "ensemble_param":
            t.fill_(1.0 / 3)
        elif t.ndim >= 2:
            std = float(np.prod(t.shape[1:])) ** -0.5
            t.copy_(std * torch.randn(t.shape, generator=generator, device=generator.device))
        else:
            t.fill_(0.0 if name.endswith("bias") else 1.0)


# ---- steps ----

def _ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return F.cross_entropy(wide(logits), labels.long())


def _all_grads(loss: torch.Tensor, tensors: dict) -> dict:
    """Grads of `loss` by name; zero where it does not reach."""
    return dict(zip(tensors, torch.autograd.grad(loss, list(tensors.values()),
                                                 materialize_grads=True)))


def make_pretrain_step(model: CDARTSController, opt, aux_weight: float = 0.4):
    """step(alphas, batch) -> loss: the supernet warmup (search_function.py
    retrain_warmup), CE on fc_super plus aux_weight · the last aux head's
    CE, every path through the search cells."""

    def step(alphas: dict, batch) -> torch.Tensor:
        model.train()
        logits, aux = model(batch["image"], alphas, pretrain=True)
        loss = _ce(logits, batch["label"])
        if aux is not None:
            loss = loss + aux_weight * _ce(aux, batch["label"])
        params = dict(model.named_parameters())
        opt.step(params, _all_grads(loss, params))
        return loss.detach()

    return step


REG_OPS = ("max_pool_3x3", "avg_pool_3x3", "skip_connect")


def make_joint_search_step(model: CDARTSController, nas_opt, alpha_opt, loss_alpha: float = 1.0,
                           loss_T: float = 2.0, interactive_type: str = "kl",
                           reg_weight: float = 0.0):
    """step(alphas, batch, layer_idx) -> (loss, accuracy): the val-batch
    update (search_function.py:30-75). The super pass, then the nas pass on
    the BN statistics the super pass left; CE of both over `loss_alpha`,
    the interactive loss between their ensemble logits times `loss_alpha`,
    `reg_weight` · the parameter-free ops' softmax weight. `nas_opt` steps
    every param (the grads the two passes give, zero elsewhere),
    `alpha_opt` the alphas; accuracy is the nas path's."""
    reg_idx = [PRIMITIVES.index(p) for p in REG_OPS]

    def step(alphas: dict, batch, layer_idx: int):
        model.train()
        a = {k: v.detach().requires_grad_(True) for k, v in alphas.items()}
        x, y = batch["image"], batch["label"]
        lg_s, em_s = model(x, a, layer_idx, super_flag=True)
        lg_n, em_n = model(x, a, layer_idx, super_flag=False)
        loss_cls = (_ce(lg_s, y) + _ce(lg_n, y)) / loss_alpha
        loss_int = interactive_loss(em_s, em_n, interactive_type, loss_T) * loss_alpha
        reg = 0.0
        if reg_weight:
            for k in ("normal", "reduce"):
                w = torch.softmax(wide(a[k]), -1)
                reg = reg + sum(w[:, i].sum() for i in reg_idx)
        loss = loss_cls + loss_int + reg_weight * reg
        params = dict(model.named_parameters())
        grads = _all_grads(loss, {**params, **{f"alpha/{k}": v for k, v in a.items()}})
        nas_opt.step(params, {k: grads[k] for k in params})
        alpha_opt.step(alphas, {k: grads[f"alpha/{k}"] for k in alphas})
        acc = (lg_n.argmax(-1) == y).float().mean()
        return loss.detach(), acc

    return step


def make_super_weight_step(model: CDARTSController, opt):
    """step(alphas, batch, layer_idx) -> loss: the train-batch super-path
    weight step (search_function.py:115-130)."""

    def step(alphas: dict, batch, layer_idx: int) -> torch.Tensor:
        model.train()
        logits, _ = model(batch["image"], alphas, layer_idx, super_flag=True)
        loss = _ce(logits, batch["label"])
        params = dict(model.named_parameters())
        opt.step(params, _all_grads(loss, params))
        return loss.detach()

    return step


@dataclasses.dataclass
class StageSearchConfig:
    layer_num: int = 3
    cells_per_layer: int = 2
    n_nodes: int = 4
    C: int = 16
    num_classes: int = 10
    pretrain_epochs: int = 1
    search_iters: int = 2
    steps_per_iter: int = 8
    w_lr: float = 0.05
    nas_lr: float = 0.05
    alpha_lr: float = 3e-4
    loss_alpha: float = 1.0
    loss_T: float = 2.0
    interactive_type: str = "kl"
    reg_weight: float = 1e-3
    aux_pool_size: int = 6
    clean_arch: bool = True


class MultiStageSearcher:
    """The staged CDARTS campaign (CDARTS/CDARTS/search.py:126-300):

    for layer_idx in 0..layer_num:
        re-draw the alphas (clean_arch, after the first layer)
        warm the super pool (pretrain epochs)
        per search iter: discretize the current alphas into layers
            layer_idx.., copy super -> nas, then alternate joint val steps
            (alphas + weights, the interactive loss) with super weight
            steps; copy nas -> super and record the genotype
        freeze layer layer_idx at its genotype

    Draws: `init_alphas(n_nodes)` gives each alpha set and `init_model(model)`
    each fresh controller's weights (by default from `generator`, drawn on
    its device); a test hands in the JAX package's draws. Every
    discretization resets the three optimizers' states, as the JAX
    package's does. `timings` holds the seconds of each pretrain, joint and
    super-weight step and each discretization (the device synchronized
    around each)."""

    def __init__(self, cfg: StageSearchConfig, *, device, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None,
                 init_alphas: Callable[[int], dict] | None = None,
                 init_model: Callable[[nn.Module], None] | None = None):
        self.cfg, self.device, self.dtype = cfg, torch.device(device), dtype
        self.generator = generator or torch.Generator().manual_seed(0)
        self.init_alphas = init_alphas or (
            lambda n: init_stage_alphas(self.generator, n, self.device))
        self.init_model = init_model or (lambda m: init_weights(m, self.generator))
        self.alphas = self.init_alphas(cfg.n_nodes)
        self.genotypes = [parse_stage_genotype(self.alphas, cfg.n_nodes)] * cfg.layer_num
        self.model = self._build()
        self.init_model(self.model)
        self._rebuild_steps()
        self.history: list = []
        self.timings = {"pretrain": [], "joint": [], "super_weight": [], "discretize": []}

    def _build(self) -> CDARTSController:
        c = self.cfg
        return CDARTSController(self.genotypes, c.num_classes, c.layer_num, c.cells_per_layer,
                                c.n_nodes, c.C, aux_pool_size=c.aux_pool_size,
                                dtype=self.dtype, device=self.device)

    def _rebuild_steps(self) -> None:
        from cream_tpu_torch.nas.cdarts import make_alpha_adam
        c = self.cfg
        self.w_opt = make_sgd(c.w_lr, momentum=0.9)
        self.nas_opt = make_sgd(c.nas_lr, momentum=0.9)
        self.alpha_opt = make_alpha_adam(c.alpha_lr)
        self._pre = make_pretrain_step(self.model, self.w_opt)
        self._joint = make_joint_search_step(self.model, self.nas_opt, self.alpha_opt,
                                             c.loss_alpha, c.loss_T, c.interactive_type,
                                             c.reg_weight)
        self._wstep = make_super_weight_step(self.model, self.w_opt)

    def _timed(self, kind: str, fn, *args):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        out = fn(*args)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.timings[kind].append(time.perf_counter() - t0)
        return out

    def _discretize(self, layers: Sequence[int]) -> None:
        """Rebuild the nas layers `layers` from the current alphas, carry
        every surviving tensor, copy super -> nas (build_nas_layers +
        copy_params_from_super_layer)."""
        g = parse_stage_genotype(self.alphas, self.cfg.n_nodes)
        for li in layers:
            self.genotypes[li] = g
        old, self.model = self.model, self._build()
        self.init_model(self.model)
        transfer_variables(self.model, old)
        copy_super_to_nas(self.model, list(layers))
        self._rebuild_steps()

    def run(self, train_batches, val_batches, log=print):
        """train_batches / val_batches: callables giving fresh iterators of
        {'image', 'label'} batches on the device."""
        c = self.cfg
        for layer_idx in range(c.layer_num):
            if c.clean_arch and layer_idx > 0:
                self.alphas = self.init_alphas(c.n_nodes)
            for ep in range(c.pretrain_epochs):
                for i, tb in enumerate(train_batches()):
                    if i >= c.steps_per_iter:
                        break
                    loss = self._timed("pretrain", self._pre, self.alphas, tb)
                log(f"[layer {layer_idx}] pretrain {ep}: loss {float(loss):.3f}")
            for it in range(c.search_iters):
                self._timed("discretize", self._discretize, range(layer_idx, c.layer_num))
                accs = []
                for i, (tb, vb) in enumerate(zip(train_batches(), val_batches())):
                    if i >= c.steps_per_iter:
                        break
                    jl, acc = self._timed("joint", self._joint, self.alphas, vb, layer_idx)
                    self._timed("super_weight", self._wstep, self.alphas, tb, layer_idx)
                    accs.append(float(acc))
                # sync the trained nas weights back into the super pool
                copy_nas_to_super(self.model, list(range(layer_idx, c.layer_num)))
                g = parse_stage_genotype(self.alphas, c.n_nodes)
                self.history.append({"layer": layer_idx, "iter": it,
                                     "val_acc": float(np.mean(accs or [0])), "genotype": g})
                log(f"[layer {layer_idx}] iter {it}: joint {float(jl):.3f} "
                    f"acc {np.mean(accs or [0]):.3f} genotype {g.normal[0]}")
            # layer-by-layer discretization: freeze this layer's genotype
            self._timed("discretize", self._discretize, [layer_idx])
        return self.genotypes, self.history
