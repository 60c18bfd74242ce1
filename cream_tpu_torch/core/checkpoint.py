"""Checkpoints with `torch.save`, and auto-resume.

Counterpart of `cream_tpu/core/checkpoint.py` on the port's own format: a
checkpoint is a directory `<ckpt_dir>/<step>/` holding `state.pt` (the
state's `state_dict()`) and `extra.json` (small JSON metadata). A step directory appears only once
complete (it is written under a temporary name and renamed), and the newest
`max_to_keep` are kept. Files are read back with `weights_only=True`.

A state split over a model group (`core.tensor_parallel`) is saved whole:
the model ranks' shards of its weights, optimizer slots and EMA are
gathered into the full state dict, which loads on one card. Under a model
group (`core.mesh.init_distributed(model=M)`) every rank calls the save:
the model peers of data rank 0 (ranks 0 to M - 1) gather, rank 0 writes,
and the other data ranks return at once. A save that a model peer of data
rank 0 does not call waits on the gather forever. `restore_checkpoint` cuts
a full checkpoint back to the state's shard.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any

import torch

from cream_tpu_torch.core.mesh import data_rank, model_group, model_rank, model_size
from cream_tpu_torch.core.tensor_parallel import gather_tree, shard_state_dict


def _cpu(tree: Any) -> Any:
    """A copy of `tree` with every tensor detached and on the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree


def _snapshot(state: Any) -> Any:
    """What a checkpoint of `state` holds, copied to the CPU, on the rank
    that writes it; None on the others. A split state's shards are
    gathered whole over the model group of data rank 0 (see the module's
    doc)."""
    if model_group() is not None and data_rank() != 0:
        return None
    tree = state.state_dict() if hasattr(state, "state_dict") else state
    tree = _cpu(gather_tree(tree, model_group()))
    return tree if model_rank() == 0 else None


def steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(d) for d in os.listdir(ckpt_dir) if re.fullmatch(r"\d+", d))


def latest_step(ckpt_dir: str) -> int | None:
    """Newest complete step in the directory, or None."""
    found = steps(ckpt_dir)
    return found[-1] if found else None


def _write(ckpt_dir: str, step: int, snap: Any, extra: dict | None,
           max_to_keep: int) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, str(step))
    tmp = f"{final}.tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(snap, os.path.join(tmp, "state.pt"))
    if extra:
        with open(os.path.join(tmp, "extra.json"), "w") as f:
            json.dump(extra, f)
    shutil.rmtree(final, ignore_errors=True)
    os.replace(tmp, final)
    for old in steps(ckpt_dir)[:-max_to_keep]:
        shutil.rmtree(os.path.join(ckpt_dir, str(old)), ignore_errors=True)


def save_checkpoint(ckpt_dir: str, step: int, state: Any,
                    extra: dict | None = None, max_to_keep: int = 3) -> None:
    """state: an object with `state_dict()` (e.g. TrainState) or a dict of
    tensors; extra: small JSON-able metadata. Under a model group every
    rank calls it (the module's doc)."""
    snap = _snapshot(state)
    if snap is not None:
        _write(ckpt_dir, step, snap, extra, max_to_keep)


class AsyncCheckpointer:
    """Saves that overlap the next training steps: `save` copies the state
    to the CPU on the caller's thread, then writes it on a background thread;
    a save waits for the previous one, and `close()` for the last.

    Usage: ck = AsyncCheckpointer(dir); ck.save(step, state, extra); ...;
    ck.close()  (or use as a context manager)."""

    def __init__(self, ckpt_dir: str, max_to_keep: int = 3):
        self.ckpt_dir, self.max_to_keep = ckpt_dir, max_to_keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save(self, step: int, state: Any, extra: dict | None = None) -> None:
        self.wait()
        snap = _snapshot(state)
        if snap is None:
            return

        def run():
            try:
                _write(self.ckpt_dir, step, snap, extra, self.max_to_keep)
            except BaseException as e:  # re-raised by wait() on the caller
                self._error = e

        self._thread = threading.Thread(target=run, daemon=False)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self) -> None:
        self.wait()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _load(ckpt_dir: str, step: int | None) -> tuple[dict, str, int]:
    if step is None:
        step = latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    path = os.path.join(ckpt_dir, str(step))
    return torch.load(os.path.join(path, "state.pt"), weights_only=True), path, step


def restore_params(ckpt_dir: str, step: int | None = None) -> dict:
    """The model weights of a TrainState checkpoint (default: the newest),
    as a `state_dict` (params and BN buffers) for `model.load_state_dict`."""
    return _load(ckpt_dir, step)[0]["model"]


def restore_checkpoint(ckpt_dir: str, state: Any, step: int | None = None
                       ) -> tuple[Any, dict | None, int]:
    """Load the checkpoint of `step` (default: the newest) into `state` (its
    `load_state_dict`; a plain dict is replaced) and return (state, extra,
    step). Under a model group the full checkpoint is cut to this rank's
    shard."""
    sd, path, step = _load(ckpt_dir, step)
    if model_group() is not None:
        sd = shard_state_dict(sd, model_rank(), model_size())
    if hasattr(state, "load_state_dict"):
        state.load_state_dict(sd)
    else:
        state = sd
    extra = None
    extra_path = os.path.join(path, "extra.json")
    if os.path.exists(extra_path):
        with open(extra_path) as f:
            extra = json.load(f)
    return state, extra, step
