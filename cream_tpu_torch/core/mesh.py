"""Data parallelism over a `torch.distributed` process group.

Counterpart of `cream_tpu/core/mesh.py`'s data axis. The JAX package jits a
step with the batch sharded over a `data` mesh and the state replicated, so
its W-device step is the one-device step on the global batch (the rank
batches concatenated in rank order): the loss mean, the gradient, the
BatchNorm batch moments and the drop-path / dropout draws are all the
global batch's. Here each rank is a process holding its rows of that batch;
the data group of the process group (`init_distributed`, torchrun's
environment) is the data axis, and the pieces that the JAX package's
compiler makes global take their collectives from this module: the step's
gradient and metric means (`all_reduce_mean_`), the train-mode BatchNorm
moments (`nn.layers.batch_norm_train`), the random draws (`ops.common`),
the eval counts (`all_reduce_sum`).

Without a process group every function here is the one-card identity:
rank 0 of 1.

The (data, model) layout. `init_distributed(device, model=M)` splits the W
ranks as the JAX package's `create_mesh({"data": W // M, "model": M})`
reshapes its devices: rank r is data index r // M and model index r % M.
The M ranks of a model group (consecutive ranks) hold the same rows of the
batch and one shard each of a tensor-parallel model (`core.tensor_parallel`,
the CLIP blocks split by heads under `CLIP_TP_RULES`); the W // M ranks of a
data group (ranks m, M + m, ...) hold the same shard and their own rows.
Every data-parallel collective above runs over the data group, so model
peers draw the same random numbers and take the same BatchNorm moments.
With M = 1 the data group is the whole world and no model group exists.
`partition_by_rules` and `CLIP_TP_RULES` are the counterparts of the JAX
package's, over the port's torch state-dict names.
"""
from __future__ import annotations

import os
import re

import numpy as np
import torch
import torch.distributed as dist

# the flat fp32 buckets of the gradient all-reduce
BUCKET_BYTES = 32 << 20


# the (data, model) layout of the live process group; set by `init_distributed`
_LAYOUT: dict = {}


def _layout() -> dict | None:
    """{"world", "data", "model", "model_size"} of the live process group
    (a group started without a model axis: the world as its data group, no
    model group), or None without one."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    world = dist.group.WORLD
    if _LAYOUT.get("world") is not world:
        _LAYOUT.clear()
        _LAYOUT.update(world=world, data=world, model=None, model_size=1)
    return _LAYOUT


def data_group():
    """The data-parallel group (the world with no model axis) while a
    process group is initialized, else None."""
    layout = _layout()
    return None if layout is None else layout["data"]


def model_group():
    """The tensor-parallel group of this rank's model peers, or None (no
    process group, or a model axis of 1)."""
    layout = _layout()
    return None if layout is None else layout["model"]


def rank() -> int:
    """This process's rank in the whole group."""
    return dist.get_rank() if data_group() is not None else 0


def world_size() -> int:
    return dist.get_world_size() if data_group() is not None else 1


def model_size() -> int:
    layout = _layout()
    return 1 if layout is None else layout["model_size"]


def model_rank() -> int:
    return rank() % model_size()


def data_rank() -> int:
    return rank() // model_size()


def data_size() -> int:
    return world_size() // model_size()


def init_distributed(device="cuda", model: int = 1) -> bool:
    """Join the process group that torchrun describes in the environment
    (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`); a
    no-op where it describes none. On a CUDA device the group is NCCL's on
    `cuda:LOCAL_RANK` (made this process's current device); gloo only when
    the caller asks for the CPU. NCCL is never swapped for gloo: a failed
    NCCL start raises. With `model` > 1 the ranks are split into data and
    model groups (see the module's doc), every group made on every rank in
    the same order; the world size must divide by `model`. Returns whether
    more than one rank runs."""
    if "WORLD_SIZE" not in os.environ:
        if model != 1:
            raise ValueError(f"init_distributed: a model axis of {model} needs a process group")
        return False
    if data_group() is None:
        kind = torch.device(device).type
        world, rank_ = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        if kind == "cuda":
            local = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(local)
            dist.init_process_group("nccl", init_method="env://", world_size=world,
                                    rank=rank_, device_id=local)
        elif kind == "cpu":
            dist.init_process_group("gloo", init_method="env://", world_size=world,
                                    rank=rank_)
        else:
            raise ValueError(f"init_distributed: no process group for device {device!r}")
    if model != 1:
        _split(model)
    return world_size() > 1


def _split(model: int) -> None:
    """Make the data and model groups of a (W // model, model) layout."""
    layout = _layout()
    if layout is None or layout["model_size"] == model:
        return
    if layout["model_size"] != 1:
        raise RuntimeError(f"init_distributed: the ranks are already split with a model axis "
                           f"of {layout['model_size']}, not {model}")
    world = dist.get_world_size()
    if model < 1 or world % model:
        raise ValueError(f"init_distributed: {world} ranks do not divide by a model axis of "
                         f"{model}")
    r = dist.get_rank()
    data = [dist.new_group(list(range(m, world, model))) for m in range(model)]
    peers = [dist.new_group(list(range(d * model, (d + 1) * model)))
             for d in range(world // model)]
    layout.update(data=data[r % model], model=peers[r // model], model_size=model)


def local_device(device) -> torch.device:
    """`device`, with a CUDA device bound to this process's current card
    (`cuda:LOCAL_RANK` after `init_distributed`)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return device


def is_main_process() -> bool:
    """Rank 0: the process that writes checkpoints, logs and results."""
    return rank() == 0


def barrier() -> None:
    """Wait for every rank of the whole group."""
    if data_group() is not None:
        dist.barrier()


def process_shard(n_or_array, index: int | None = None, count: int | None = None):
    """This rank's strided slice of a sample order: the DistributedSampler
    role (each data rank reads only its own samples; the union over data
    ranks is the whole order, disjoint; model peers read the same)."""
    index = data_rank() if index is None else index
    count = data_size() if count is None else count
    if isinstance(n_or_array, int):
        n_or_array = np.arange(n_or_array)
    return n_or_array[index::count]


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """t summed over the data ranks, in place (the eval counts)."""
    if data_group() is not None:
        dist.all_reduce(t, group=data_group())
    return t


def all_reduce_mean_(tensors, bucket_bytes: int = BUCKET_BYTES) -> None:
    """Replace each tensor by its mean over the data ranks: packed into flat
    fp32 buckets of up to `bucket_bytes`, one all-reduce a bucket."""
    group = data_group()
    if group is None:
        return
    for bucket in _buckets(tensors, bucket_bytes):
        flat = torch.cat([t.reshape(-1).float() for t in bucket])
        dist.all_reduce(flat, group=group)
        flat /= data_size()
        for t, part in zip(bucket, flat.split([t.numel() for t in bucket])):
            t.copy_(part.view_as(t))


def _buckets(tensors, bucket_bytes: int):
    """Consecutive runs of `tensors` of at most `bucket_bytes` in fp32 (a
    larger tensor alone)."""
    bucket, size = [], 0
    for t in tensors:
        if bucket and size + 4 * t.numel() > bucket_bytes:
            yield bucket
            bucket, size = [], 0
        bucket.append(t)
        size += 4 * t.numel()
    if bucket:
        yield bucket


def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """The data ranks' `t` (all of one shape) concatenated along dim 0 in
    data-rank order; t itself without a group."""
    group = data_group()
    if group is None:
        return t
    parts = [torch.empty_like(t) for _ in range(data_size())]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts)


def broadcast_module(module: torch.nn.Module, src: int = 0) -> None:
    """Give every rank of a data group the parameters and buffers of the
    group's data rank `src` (model peers keep their own shards)."""
    group = data_group()
    if group is None:
        return
    src = dist.get_global_rank(group, src)
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src, group=group)


def global_rows(n: int) -> tuple[int, int, int]:
    """(global rows, first row, last row + 1) of this rank's `n` rows of a
    global batch whose data ranks each hold `n` rows, concatenated in
    data-rank order (model peers hold the same rows)."""
    r, w = data_rank(), data_size()
    return w * n, r * n, (r + 1) * n


def partition_by_rules(names, rules) -> dict:
    """Each name of `names` (a state dict's keys, or the dict itself)
    mapped to the split of the first rule whose regex fullmatches it, else
    None (replicated): the counterpart of the JAX package's
    `partition_by_rules` over the port's state-dict names."""
    compiled = [(re.compile(pat), spec) for pat, spec in rules]

    def spec_for(name: str):
        return next((spec for pat, spec in compiled if pat.fullmatch(name)), None)
    return {name: spec_for(name) for name in names}


# Megatron-style tensor parallelism of the CLIP towers' blocks: the JAX
# package's rules (`cream_tpu/core/mesh.py`) on torch's (out, in) Linear
# weights, so JAX's P(None, "model") on a kernel is a split of rows here.
#   "heads"  rows of in_proj, whole heads of each of q, k and v (JAX splits
#            the fused 3 * inner columns into contiguous chunks instead)
#   "rows"   dim 0 (c_fc: the MLP's hidden channels)
#   "cols"   dim 1 (out_proj and c_proj: the heads' and hidden channels)
# Everything else is replicated: the LayerNorms, embeddings, conv1, proj,
# logit_scale, and the biases of out_proj and c_proj, which are added once
# after the model group's sum.
CLIP_TP_RULES = (
    (r".*\.attn\.in_proj_weight", "heads"),
    (r".*\.attn\.in_proj_bias", "heads"),
    (r".*\.attn\.out_proj\.weight", "cols"),
    (r".*\.mlp\.c_fc\.weight", "rows"),
    (r".*\.mlp\.c_fc\.bias", "rows"),
    (r".*\.mlp\.c_proj\.weight", "cols"),
)
