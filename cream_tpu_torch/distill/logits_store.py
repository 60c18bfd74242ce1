"""Sparse teacher-logits store for fast pretraining distillation.

Counterpart of `cream_tpu/distill/logits_store.py`, in the same file format
byte for byte, so a store either package writes the other reads: per
(epoch, sample) the teacher's top-K softmax values (fp16), class indices
(int16) and the augmentation seed (int32), in `epoch{e}.bin` at
`sample_index * record_size` (little-endian `seed <i4 | K values <f2 | K
ids <i2`), and `meta.json` with the keys version, topk, num_classes,
num_samples and record_size.

The port adds a sidecar, `recipe.json`: what the teacher saw (the writer,
the pixel transform, the mixup stream and its settings). The JAX package
neither writes nor reads it, so its meta.json stays the same. A trainer
replays a store only when the store's recipe equals its own
(`check_recipe`); `LogitsReader` reads any store.
"""
from __future__ import annotations

import json
import os

import numpy as np

from cream_tpu_torch.distill import native

RECIPE = "recipe.json"


def _paths(root: str, epoch: int) -> tuple[str, str]:
    return (os.path.join(root, f"epoch{epoch}.bin"),
            os.path.join(root, "meta.json"))


def _check_indices(idx: np.ndarray, num_samples: int) -> None:
    if idx.size and (idx.min() < 0 or idx.max() >= num_samples):
        raise IndexError(f"sample indices outside [0, {num_samples}): "
                         f"{idx.min()}..{idx.max()}")


class LogitsWriter:
    """Random-access writer of one epoch's file; one process per file.

    `use_native`: pack and pwrite through the C++ codec (`distill.native`,
    built at first use; a failed build raises), else through a numpy memmap.
    Both give the same bytes."""

    def __init__(self, root: str, epoch: int, num_samples: int, topk: int,
                 num_classes: int, use_native: bool = True):
        os.makedirs(root, exist_ok=True)
        self.topk = topk
        self.num_classes = num_classes
        self.num_samples = num_samples
        bin_path, meta_path = _paths(root, epoch)
        self.record_size = 4 + 2 * topk + 2 * topk
        meta = {"version": 1, "topk": topk, "num_classes": num_classes,
                "num_samples": num_samples, "record_size": self.record_size}
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                old = json.load(f)
            if old != meta:
                raise ValueError(f"incompatible logits store: {old} vs {meta}")
        else:
            with open(meta_path, "w") as f:
                json.dump(meta, f)
        if self.num_classes > np.iinfo(np.int16).max:
            raise ValueError("num_classes exceeds int16 index range")

        total = num_samples * self.record_size
        self.native = use_native
        if self.native:
            native.load()
            self._fd = os.open(bin_path, os.O_RDWR | os.O_CREAT, 0o644)
            os.ftruncate(self._fd, total)
            self._mm = None
        else:
            self._fd = None
            self._mm = np.memmap(bin_path, dtype=np.uint8, mode="w+",
                                 shape=(total,))

    def write_batch(self, sample_indices: np.ndarray, seeds: np.ndarray,
                    values: np.ndarray, class_indices: np.ndarray):
        """values: (B, K) float probs; class_indices: (B, K) int; seeds (B,)."""
        K = self.topk
        idx = np.asarray(sample_indices, np.int64)
        _check_indices(idx, self.num_samples)
        B = len(idx)
        if self.native:
            native.pack_write(self._fd, np.asarray(values, np.float32),
                              np.asarray(class_indices, np.int32),
                              np.asarray(seeds, np.int32), idx)
            return
        rec = np.empty((B, self.record_size), dtype=np.uint8)
        rec[:, :4] = np.asarray(seeds, "<i4").view(np.uint8).reshape(B, 4)
        rec[:, 4:4 + 2 * K] = np.asarray(values, "<f2").view(np.uint8).reshape(B, -1)
        rec[:, 4 + 2 * K:] = np.asarray(class_indices, "<i2").view(np.uint8).reshape(B, -1)
        for i, j in enumerate(idx):
            off = int(j) * self.record_size
            self._mm[off:off + self.record_size] = rec[i]

    def close(self):
        if self.native:
            os.close(self._fd)
        else:
            self._mm.flush()
            del self._mm


class LogitsReader:
    """Reads one epoch's records by sample index (native codec or numpy)."""

    def __init__(self, root: str, epoch: int, use_native: bool = True):
        bin_path, meta_path = _paths(root, epoch)
        with open(meta_path) as f:
            meta = json.load(f)
        self.topk = meta["topk"]
        self.num_classes = meta["num_classes"]
        self.num_samples = meta["num_samples"]
        self.record_size = meta["record_size"]
        self.native = use_native
        if self.native:
            native.load()
            self._fd = os.open(bin_path, os.O_RDONLY)
            self._mm = None
        else:
            self._fd = None
            self._mm = np.memmap(bin_path, dtype=np.uint8, mode="r")

    def read_batch(self, sample_indices: np.ndarray
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """-> (values (B,K) f32, class_indices (B,K) i32, seeds (B,) i32)."""
        K = self.topk
        idx = np.asarray(sample_indices, np.int64)
        _check_indices(idx, self.num_samples)
        if self.native:
            return native.read_unpack(self._fd, idx, K)
        recs = np.stack([
            self._mm[i * self.record_size:(i + 1) * self.record_size]
            for i in idx])
        seeds = recs[:, :4].copy().view("<i4").reshape(-1)
        values = recs[:, 4:4 + 2 * K].copy().view("<f2").astype(np.float32)
        classes = recs[:, 4 + 2 * K:].copy().view("<i2").astype(np.int32)
        return values, classes, seeds

    def close(self):
        if self.native:
            os.close(self._fd)
        else:
            del self._mm


def write_recipe(root: str, recipe: dict) -> None:
    """Record what the teacher saw beside meta.json; a store that already
    holds another recipe is refused, as an incompatible meta.json is."""
    path = os.path.join(root, RECIPE)
    if os.path.exists(path):
        with open(path) as f:
            old = json.load(f)
        if old != recipe:
            raise ValueError(f"logits store {root} was written with recipe {old}, "
                             f"not {recipe}")
        return
    os.makedirs(root, exist_ok=True)
    with open(path, "w") as f:
        json.dump(recipe, f, sort_keys=True)


def check_recipe(root: str, recipe: dict) -> None:
    """Raise unless the store at `root` was written with `recipe`: replaying
    a store whose teacher saw other pixels would train on wrong targets."""
    path = os.path.join(root, RECIPE)
    if not os.path.exists(path):
        raise ValueError(
            f"logits store {root} has no {RECIPE}: it was not written by this "
            f"package's save_logits (a JAX-written store's teacher saw the JAX "
            f"package's PIL augmentation and mixup draws, which this trainer "
            f"does not replay), so its teacher outputs are for other pixels")
    with open(path) as f:
        stored = json.load(f)
    if stored != recipe:
        raise ValueError(f"logits store {root} was written with recipe {stored}; "
                         f"this run replays {recipe}")


def check_saved_logits(reader: LogitsReader, teacher_fn, dataset_iter,
                       atol: float = 2e-2) -> dict:
    """--check-saved-logits equivalent (save_logits.py:182-230): re-run the
    teacher on the stored seeds' augmentations and measure value error and
    index mismatch rate. `teacher_fn(image) -> (B, C)` dense probs (numpy)."""
    n, val_err, idx_diff, idx_miss = 0, 0.0, 0.0, 0.0
    for batch in dataset_iter:
        values, classes, seeds = reader.read_batch(batch["index"])
        probs = teacher_fn(batch["image"])          # (B, C) dense probs
        k = values.shape[1]
        top_idx = np.argsort(-probs, axis=-1)[:, :k]
        top_val = np.take_along_axis(probs, top_idx, axis=-1)
        val_err += float(np.abs(top_val - values).mean()) * len(values)
        # reference metric (check_logits_one_epoch): elementwise index
        # equality — inflated by fp16 ties, keep for parity
        idx_diff += float((top_idx != classes).mean()) * len(values)
        # tie-aware miss: the stored class's RECOMPUTED prob must match its
        # stored value; order flips between tied probs don't count
        at_stored = np.take_along_axis(probs, classes.astype(np.int64), -1)
        idx_miss += float((np.abs(at_stored - values) > atol).mean()) * len(values)
        n += len(values)
    return {"value_abs_err": val_err / max(n, 1),
            "index_diff_rate": idx_diff / max(n, 1),
            "index_miss_rate": idx_miss / max(n, 1), "n": n}
