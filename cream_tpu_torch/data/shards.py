"""Tar-shard image-text dataset reader (TinyCLIP's webdataset capability).

Counterpart of `cream_tpu/data/shards.py` (TinyCLIP/src/training/data.py:
35-260): a list of .tar shards each containing paired members (xxx.jpg +
xxx.txt), iterated with a resumable deterministic shuffle (detshuffle2
semantics: the shuffle is a pure function of (seed, epoch)), decoded and
batched host-side. Also a CsvDataset equivalent: filepath<TAB>caption rows.

The exact path decodes (`image_io.read_rgb`) and resizes + crops
(`transforms.preprocess_pil`) on `num_workers` processes
(`imagenet.Workers`), giving the JAX reader's batches bit for bit; the
native path (`native_pipe`) decodes a batch in the loader's own thread.
"""
from __future__ import annotations

import os
import tarfile
from typing import Iterator

import numpy as np

from cream_tpu_torch.data import native_pipe
from cream_tpu_torch.data.image_io import read_rgb
from cream_tpu_torch.data.imagenet import Workers
from cream_tpu_torch.data.transforms import eval_preprocess_config, preprocess_pil

IMAGE_EXTS = ("jpg", "jpeg", "png", "webp")


def iter_tar_pairs(shard_path: str) -> Iterator[tuple[str, bytes, bytes]]:
    """Yield (key, image_bytes, text_bytes) pairs from one shard."""
    with tarfile.open(shard_path) as tf:
        pending: dict[str, dict] = {}
        for member in tf:
            if not member.isfile():
                continue
            key, ext = os.path.splitext(member.name)
            ext = ext.lower().lstrip(".")
            if ext not in IMAGE_EXTS + ("txt", "json"):
                continue
            d = pending.setdefault(key, {})
            d[ext] = tf.extractfile(member).read()
            img = next((d[e] for e in IMAGE_EXTS if e in d), None)
            if img is not None and "txt" in d:
                yield key, img, d["txt"]
                del pending[key]


class ShardListDataset:
    """Deterministically-shuffled iterator over image-text tar shards."""

    def __init__(self, shards: list[str], seed: int = 0):
        self.shards = sorted(shards)
        self.seed = seed

    def epoch_iter(self, epoch: int, start_sample: int = 0
                   ) -> Iterator[tuple[str, bytes, bytes]]:
        """The shuffle is a pure function of (seed, epoch) — detshuffle2
        semantics (TinyCLIP/src/training/data.py:35) — so `start_sample`
        fast-forwards deterministically into the epoch: mid-epoch resume
        replays the identical stream from sample N on."""
        order = np.arange(len(self.shards))
        np.random.default_rng(self.seed + epoch).shuffle(order)  # detshuffle2
        skipped = 0
        for si in order:
            for pair in iter_tar_pairs(self.shards[si]):
                if skipped < start_sample:
                    skipped += 1
                    continue
                yield pair


class _DecodeImage:
    """The exact path's worker function: image bytes -> normalized float32
    HWC (the eval resize + crop of `cfg`)."""

    def __init__(self, cfg):
        self.cfg = cfg

    def __call__(self, data: bytes) -> np.ndarray:
        return preprocess_pil(read_rgb(data), self.cfg)


def _native_images(bufs: list, cfg, decode: _DecodeImage, n_threads: int) -> np.ndarray:
    """A batch through the native pipeline in this thread; a member it
    cannot decode (PNG, WebP, truncated bytes) takes the exact path."""
    wh = native_pipe.probe_sizes(bufs)
    images, status = native_pipe.decode_batch(
        bufs, native_pipe.eval_params(wh, cfg), cfg.crop, cfg.mean, cfg.std,
        n_threads=n_threads, allow_prescale=False)
    for j in np.nonzero((status != 0) | (wh[:, 0] <= 0))[0]:
        images[int(j)] = decode(bufs[int(j)])
    return images


def image_text_loader(dataset: ShardListDataset, tokenizer, epoch: int,
                      batch_size: int, img_size: int = 224,
                      context_length: int = 77, num_workers: int = 8,
                      start_batch: int = 0, native=False) -> Iterator[dict]:
    """Batches of {image (B,H,W,3) CLIP-normalized, text (B,L) tokens}.

    `start_batch` resumes mid-epoch: the first start_batch*batch_size
    samples of the deterministic epoch stream are skipped, so a checkpoint
    carrying iter_in_epoch restarts on exactly the next unseen batch
    (TinyCLIP/src/training/main.py:400 iter_in_epoch resume).
    native: False | True | "auto" — decode/resize JPEG members through the
    C++ pipeline (`native_pipe`, in this thread, no worker process
    started), per-pair exact-path fallback for non-JPEG members; True
    raises where the library does not build, "auto" then takes the exact
    path. The final partial batch is dropped, as in JAX."""
    cfg = eval_preprocess_config(img_size, crop=True, clip=True)
    use_native = native_pipe.use_native(native)
    decode = _DecodeImage(cfg)

    buf: list = []
    with Workers(decode, 1 if use_native else num_workers) as pool:
        for pair in dataset.epoch_iter(epoch, start_sample=start_batch * batch_size):
            buf.append(pair)
            if len(buf) == batch_size:
                texts = [p[2].decode("utf-8", errors="replace").strip() for p in buf]
                bufs = [p[1] for p in buf]
                if use_native:
                    images = _native_images(bufs, cfg, decode, num_workers)
                else:
                    images = np.stack(pool.map(bufs))
                yield {"image": images, "text": tokenizer(texts, context_length)}
                buf = []


class CsvDataset:
    """filepath<TAB>caption rows (TinyCLIP CsvDataset, data.py:16-34);
    `load(i)` -> (uint8 (H, W, 3) RGB, caption), as `ImageFolder.load`."""

    def __init__(self, csv_path: str, sep: str = "\t",
                 img_key: int = 0, caption_key: int = 1):
        self.root = os.path.dirname(os.path.abspath(csv_path))
        self.rows = []
        with open(csv_path) as f:
            for line in f:
                parts = line.rstrip("\n").split(sep)
                if len(parts) > max(img_key, caption_key):
                    self.rows.append((parts[img_key], parts[caption_key]))

    def __len__(self):
        return len(self.rows)

    def load(self, i: int) -> tuple[np.ndarray, str]:
        path, caption = self.rows[i]
        if not os.path.isabs(path):
            path = os.path.join(self.root, path)
        return read_rgb(path), caption
