"""Tensor parallelism of the CLIP towers' blocks over a `model` group.

Counterpart of the JAX package's `partition_by_rules(params, CLIP_TP_RULES,
mesh)` (`cream_tpu/core/mesh.py`), written Megatron's way. Two design
differences from JAX:

  * The split follows heads, not the layout. JAX shards the fused
    in_proj kernel's 3 * inner columns into contiguous chunks and XLA's
    partitioner reshards whatever it must. Here each model rank holds whole
    heads of q, k and v (rows of `in_proj_weight`), their columns of
    `out_proj`, and its share of the MLP's hidden channels (rows of `c_fc`,
    columns of `c_proj`). The results are the same; only the shard layout
    differs. So every split block's heads and MLP width must divide by the
    model size: where they do not, the model raises with the layer's name
    and never falls back to a replicated block (JAX's 2-head test CLIP
    cannot take a model axis of 4; TinyCLIP-61M/32's 10-head vision tower
    splits over 2, not 4).
  * The collectives are explicit (JAX gets them from XLA): `copy_to_model`
    at the input of the column-split layers (the identity forward, the
    backward's sum over the model group) and `reduce_from_model` after the
    row-split ones (the forward's sum, the identity backward). The partial
    products are summed in fp32, then the replicated bias is added once and
    the sum cast to the compute dtype, so bf16 stays close to the unsplit
    GEMM. Both run inside `record_function("model_all_reduce")`, whose
    device ms `cli.profile_step.profile(..., ranges=)` reads.

A split model's group has one source, `core.mesh`'s (data, model) layout:
`current_shard()` after `init_distributed(model=M)`. A `ModelShard` over
another group of more than one rank raises, since the data-parallel means
run over `core.mesh`'s data group. `mark_split` records the group on each
split parameter, and the optimizer's norm sums the shards' squares over it.

`shard_state_dict` cuts a full state dict (the microsoft/Cream names, which
`cream_tpu.zoo.load.convert_for_model` bridges to JAX) into a rank's shard
by `core.mesh.CLIP_TP_RULES`; `gather_state_dict` joins the model ranks'
shards back, exactly. `shard_state_dict` and `gather_tree` (the model
group's collective inverse) also take a training state's nested dicts (the
weights, the optimizer's slots, the EMA), which `core.checkpoint` uses to
save a split state whole and to restore it.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.distributed as dist

from cream_tpu_torch.core import mesh
from cream_tpu_torch.core.mesh import CLIP_TP_RULES, partition_by_rules

# CLIP's head width: every CLIP of the port (and of microsoft/Cream) has
# heads of 64, so the fused in_proj rows of a layer give its head count
HEAD_DIM = 64


@dataclasses.dataclass(frozen=True)
class ModelShard:
    """Which shard of a split model a module holds: model rank `rank` of
    `size`, its collectives over `group` (None: none, each rank's output is
    its partial sum, for checks that sum the shards by hand)."""
    rank: int
    size: int
    group: object = None

    def __post_init__(self):
        # one source for the model group: a split model's sums, its norm
        # and the data-parallel means (over `core.mesh`'s data group) must
        # all see the same layout
        if self.group is None:
            return
        if dist.get_world_size(self.group) != self.size:
            raise ValueError(f"ModelShard: a group of {dist.get_world_size(self.group)} ranks "
                             f"for a model axis of {self.size}")
        if self.size > 1 and self.group is not mesh.model_group():
            raise ValueError("ModelShard: the group is not core.mesh's model group; build the "
                             "shard with current_shard() after init_distributed(model=M)")

    def split(self, n: int, what: str) -> int:
        """This rank's share of n heads or channels; raises naming `what`."""
        if n % self.size:
            raise ValueError(f"{what}: {n} does not split over a model axis of {self.size}")
        return n // self.size

    def part(self, n: int) -> slice:
        """This rank's slice of n (heads, channels), split evenly."""
        k = n // self.size
        return slice(self.rank * k, (self.rank + 1) * k)


def current_shard() -> ModelShard | None:
    """This process's shard under `core.mesh`'s (data, model) layout, or
    None without a model axis."""
    if mesh.model_size() == 1:
        return None
    return ModelShard(mesh.model_rank(), mesh.model_size(), mesh.model_group())


def mark_split(shard: ModelShard, *params: torch.nn.Parameter) -> None:
    """Mark parameters that hold `shard`'s part of a split tensor, with the
    group their shards span (the optimizer's norm sums their squares over
    it; None: a shard without collectives, whose norm is its own)."""
    for p in params:
        p.model_group = shard.group


def is_split(t: torch.Tensor) -> bool:
    return hasattr(t, "model_group")


def split_group(t: torch.Tensor):
    """The model group that `t`'s shards span, or None (a whole tensor, or
    a shard without collectives)."""
    return getattr(t, "model_group", None)


class _CopyToModel(torch.autograd.Function):
    """The identity forward; the backward sums the grad over the model
    group (in fp32), as every rank's heads read the same input."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        with torch.profiler.record_function("model_all_reduce"):
            g = grad.float().contiguous().clone()
            dist.all_reduce(g, group=ctx.group)
            return g.to(grad.dtype), None


class _ReduceFromModel(torch.autograd.Function):
    """The sum over the model group forward (in place on a copy); the
    identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        with torch.profiler.record_function("model_all_reduce"):
            total = x.contiguous().clone()
            dist.all_reduce(total, group=group)
            return total

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFromModel.apply(x, group)


def row_parallel_out(partial: torch.Tensor, bias: torch.Tensor | None, dtype: torch.dtype,
                     group) -> torch.Tensor:
    """A row-split layer's output from this rank's fp32 partial product:
    summed over the model group, the replicated bias (cast to `dtype`, as
    the unsplit layer casts it) added once, cast to `dtype`."""
    out = reduce_from_model(partial, group)
    if bias is not None:
        out = out + bias.to(dtype).float()
    return out.to(dtype)


# ---- state dicts ----

def _split_tensor(t: torch.Tensor, spec: str, rank: int, size: int, name: str) -> torch.Tensor:
    shard = ModelShard(rank, size)
    if spec == "heads":
        if t.shape[0] % (3 * HEAD_DIM):
            raise ValueError(f"{name}: {t.shape[0]} rows are not q, k and v of heads of "
                             f"{HEAD_DIM}")
        heads = t.shape[0] // (3 * HEAD_DIM)
        shard.split(heads, f"{name}: heads")
        v = t.reshape(3, heads, HEAD_DIM, *t.shape[1:])[:, shard.part(heads)]
        return v.reshape(-1, *t.shape[1:]).clone()
    dim = {"rows": 0, "cols": 1}[spec]
    shard.split(t.shape[dim], f"{name}: dim {dim}")
    return t.narrow(dim, shard.part(t.shape[dim]).start, t.shape[dim] // size).clone()


def _join_tensors(parts: Sequence[torch.Tensor], spec: str) -> torch.Tensor:
    if spec == "heads":
        rest = parts[0].shape[1:]
        views = [p.reshape(3, -1, HEAD_DIM, *rest) for p in parts]
        return torch.cat(views, dim=1).reshape(-1, *rest)
    return torch.cat(list(parts), dim={"rows": 0, "cols": 1}[spec])


def _map_tree(tree, leaf):
    """`tree` (a state dict, or nested dicts, lists and tuples: a training
    state's `state_dict()`) with each tensor t under a key that a rule
    splits, or under a dict whose key a rule splits (an optimizer's slots
    by parameter name), replaced by leaf(t, spec, name)."""
    def walk(node, spec, name):
        if isinstance(node, torch.Tensor):
            return node if spec is None else leaf(node, spec, name)
        if isinstance(node, dict):
            specs = partition_by_rules(node, CLIP_TP_RULES)
            return {k: walk(v, specs[k] or spec, k if specs[k] else name)
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, spec, name) for v in node)
        return node
    return walk(tree, None, "")


def shard_state_dict(full_sd, model_rank: int, model_size: int):
    """Model rank `model_rank`'s shard of a full state dict (or of a full
    training state's `state_dict()`: the weights, the optimizer's slots,
    the EMA) under `CLIP_TP_RULES`: the split tensors cut (whole heads of
    HEAD_DIM of q, k and v for "heads"), the rest as they are (the same
    tensors). Raises where a split does not divide."""
    return _map_tree(full_sd, lambda t, spec, name: _split_tensor(
        t, spec, model_rank, model_size, name))


def gather_state_dict(shards: Sequence[dict]) -> dict:
    """The full state dict from the model ranks' shards (in model-rank
    order): the inverse of `shard_state_dict`, exact. Replicated tensors
    are model rank 0's."""
    specs = partition_by_rules(shards[0], CLIP_TP_RULES)
    return {k: v if specs[k] is None else _join_tensors([s[k] for s in shards], specs[k])
            for k, v in shards[0].items()}


def gather_tree(tree, group):
    """`tree` (a state dict or a training state's `state_dict()`) with the
    model group's shards of every split tensor joined: the weights, the
    optimizer's slots and the EMA of a split model, whole. Collective over
    `group`; `tree` itself without one."""
    if group is None:
        return tree

    def join(t, spec, name):
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, t.contiguous(), group=group)
        return _join_tensors(parts, spec)
    return _map_tree(tree, join)
