"""Data parallelism over a `torch.distributed` process group.

Counterpart of `cream_tpu/core/mesh.py`'s data axis. The JAX package jits a
step with the batch sharded over a `data` mesh and the state replicated, so
its W-device step is the one-device step on the global batch (the rank
batches concatenated in rank order): the loss mean, the gradient, the
BatchNorm batch moments and the drop-path / dropout draws are all the
global batch's. Here each rank is a process holding its rows of that batch;
the default process group (`init_distributed`, torchrun's environment) is
the data axis, and the pieces that the JAX package's compiler makes global
take their collectives from this module: the step's gradient and metric
means (`all_reduce_mean_`), the train-mode BatchNorm moments
(`nn.layers.batch_norm_train`), the random draws (`ops.common`), the eval
counts (`all_reduce_sum`).

Without a process group every function here is the one-card identity:
rank 0 of 1.

The tensor-parallel `model` axis (`partition_by_rules`, `CLIP_TP_RULES`:
the CLIP towers split by heads) is not ported yet.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

# the flat fp32 buckets of the gradient all-reduce
BUCKET_BYTES = 32 << 20


def data_group():
    """The data-parallel group (the default process group) while one is
    initialized, else None."""
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


def rank() -> int:
    return dist.get_rank() if data_group() is not None else 0


def world_size() -> int:
    return dist.get_world_size() if data_group() is not None else 1


def init_distributed(device="cuda") -> bool:
    """Join the process group that torchrun describes in the environment
    (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`); a
    no-op where it describes none. On a CUDA device the group is NCCL's on
    `cuda:LOCAL_RANK` (made this process's current device); gloo only when
    the caller asks for the CPU. NCCL is never swapped for gloo: a failed
    NCCL start raises. Returns whether more than one rank runs."""
    if "WORLD_SIZE" not in os.environ:
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
    return world_size() > 1


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
    if data_group() is not None:
        dist.barrier()


def process_shard(n_or_array, index: int | None = None, count: int | None = None):
    """This rank's strided slice of a sample order: the DistributedSampler
    role (each rank reads only its own samples; the union over ranks is the
    whole order, disjoint)."""
    index = rank() if index is None else index
    count = world_size() if count is None else count
    if isinstance(n_or_array, int):
        n_or_array = np.arange(n_or_array)
    return n_or_array[index::count]


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """t summed over the ranks, in place (the eval counts)."""
    if data_group() is not None:
        dist.all_reduce(t)
    return t


def all_reduce_mean_(tensors, bucket_bytes: int = BUCKET_BYTES) -> None:
    """Replace each tensor by its mean over the ranks: packed into flat fp32
    buckets of up to `bucket_bytes`, one all-reduce a bucket."""
    if data_group() is None:
        return
    for bucket in _buckets(tensors, bucket_bytes):
        flat = torch.cat([t.reshape(-1).float() for t in bucket])
        dist.all_reduce(flat)
        flat /= world_size()
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
    """The ranks' `t` (all of one shape) concatenated along dim 0 in rank
    order; t itself without a group."""
    if data_group() is None:
        return t
    parts = [torch.empty_like(t) for _ in range(world_size())]
    dist.all_gather(parts, t.contiguous())
    return torch.cat(parts)


def broadcast_module(module: torch.nn.Module, src: int = 0) -> None:
    """Give every rank rank `src`'s parameters and buffers."""
    if data_group() is None:
        return
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src)


def global_rows(n: int) -> tuple[int, int, int]:
    """(global rows, first row, last row + 1) of this rank's `n` rows of a
    global batch whose ranks each hold `n` rows, concatenated in rank
    order."""
    r, w = rank(), world_size()
    return w * n, r * n, (r + 1) * n
