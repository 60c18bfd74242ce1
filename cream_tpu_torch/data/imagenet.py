"""Datasets and loaders for arrays: the synthetic set, a prefetching thread,
and train/eval batch loaders that only normalize.

Counterpart of part of `cream_tpu/data/imagenet.py`. `SyntheticDataset`
gives the same `default_rng(i)` uint8 images and labels as the JAX
package's, as arrays rather than PIL images. The image-file datasets and
the train augmentation (random resized crop, flip, RandAugment, random
erasing) are PIL-based there and are not ported yet, so the train loader
here normalizes without augmenting. Batches are numpy NHWC dicts
{image, label, index}; train batches also carry each sample's augmentation
seed (`seed`, int32), as the JAX loader's do, for distillation replay.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np

from cream_tpu_torch.data.det_aug import sample_seed
from cream_tpu_torch.data.samplers import repeated_aug_order
from cream_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD


class SyntheticDataset:
    """Deterministic random images; for smoke tests and throughput runs.
    `load(i)` -> (uint8 (img_size, img_size, 3), int label)."""

    def __init__(self, n: int = 1024, img_size: int = 224, num_classes: int = 1000):
        self.n, self.img_size, self.num_classes = n, img_size, num_classes

    def __len__(self):
        return self.n

    def load(self, i: int) -> tuple[np.ndarray, int]:
        rng = np.random.default_rng(i)
        arr = rng.integers(0, 256, (self.img_size, self.img_size, 3),
                           dtype=np.uint8)
        return arr, int(rng.integers(self.num_classes))


def normalize_uint8(img: np.ndarray) -> np.ndarray:
    """uint8 HWC -> float32 (img/255 - mean) / std, ImageNet constants."""
    x = img.astype(np.float32) / 255.0
    return ((x - np.asarray(IMAGENET_MEAN, np.float32))
            / np.asarray(IMAGENET_STD, np.float32))


def prefetch(it: Iterator, depth: int = 2) -> Iterator:
    """Run a batch iterator on a background thread with a bounded queue, so
    host-side loading overlaps the card's steps; loader errors are raised on
    the consumer's side."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = object()

    def run():
        try:
            for item in it:
                q.put(item)
            q.put(stop)
        except BaseException as e:  # surface loader errors on the consumer
            q.put(e)

    threading.Thread(target=run, daemon=True).start()
    while True:
        item = q.get()
        if item is stop:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def _batch(dataset, idx, pool) -> dict:
    results = list(pool.map(lambda i: dataset.load(int(i)), idx))
    return {"image": np.stack([normalize_uint8(r[0]) for r in results]),
            "label": np.asarray([r[1] for r in results], np.int32),
            "index": np.asarray(idx, np.int32)}


def train_loader(dataset, batch_size: int, epoch: int, base_seed: int = 0,
                 num_workers: int = 8, repeated_aug: int = 0) -> Iterator[dict]:
    """Seeded training batches of an array dataset, normalized, in the JAX
    loader's epoch order: the `default_rng(base_seed + epoch)` permutation,
    or with `repeated_aug` > 1 the RASampler order of
    `repeated_aug_order(n, epoch, base_seed, repeated_aug)`; the last
    partial batch dropped. Each sample's `seed` is the JAX loader's,
    `sample_seed(base_seed + 101 * repeat, epoch, index)`."""
    n = len(dataset)
    if repeated_aug > 1:
        order, reps = repeated_aug_order(n, epoch, base_seed, repeated_aug)
    else:
        order = np.random.default_rng(base_seed + epoch).permutation(n)
        reps = np.zeros(n, np.int64)
    m = len(order)
    with ThreadPoolExecutor(num_workers) as pool:
        for start in range(0, m - m % batch_size, batch_size):
            idx = order[start:start + batch_size]
            batch = _batch(dataset, idx, pool)
            batch["seed"] = np.asarray(
                [sample_seed(base_seed + 101 * int(r), epoch, int(i))
                 for i, r in zip(idx, reps[start:start + batch_size])], np.int32)
            yield batch


def eval_loader(dataset, batch_size: int, num_workers: int = 8) -> Iterator[dict]:
    """Batches in dataset order; the final partial batch is padded with
    label -1 (the eval step masks those), so every batch has one shape."""
    n = len(dataset)
    with ThreadPoolExecutor(num_workers) as pool:
        for start in range(0, n, batch_size):
            b = _batch(dataset, np.arange(start, min(start + batch_size, n)), pool)
            pad = batch_size - len(b["label"])
            if pad:
                b["image"] = np.concatenate(
                    [b["image"], np.zeros((pad,) + b["image"].shape[1:], np.float32)])
                b["label"] = np.concatenate([b["label"], -np.ones(pad, np.int32)])
                b["index"] = np.concatenate([b["index"], -np.ones(pad, np.int32)])
            yield b
