"""ImageNet-style datasets + loaders (host-side, on worker processes).

Counterpart of `cream_tpu/data/imagenet.py`:
  * ImageFolder directories, zip-cached ImageNet (MiniViT's zipreader /
    cached_image_folder) and TinyViT's ImageNet-22k layout, decoded by
    `image_io.read_rgb` to uint8 RGB arrays (uncompressed BMP without
    Pillow, other formats through Pillow)
  * the seeded train augmentation (`det_aug`) and the eval resize + crop
    (`transforms.preprocess_pil`), Pillow's pixels computed in numpy
  * synthetic data for smoke tests and throughput runs
  * `native=True | "auto"`: the eval resize + crop and the plain RRC + flip
    through the C++ image pipeline (`native_pipe`, JPEG), in the loader's
    own thread, with the exact path's decisions and pixels within ~1/255
On the exact path (the default) the loaders give the JAX loaders' batches
exactly: numpy NHWC dicts {image, label, index} (train batches also carry
each sample's `seed`), in the same order, with the same padding and host
sharding.

The JAX loaders decode and augment on `num_workers` threads; here those are
processes (`Workers`). The recipe is hundreds of numpy calls an image of
~0.1 ms each, and threads running it hand the GIL over at every call: on
the H100 machine's 8-core host 8 threads ran slower than one, and they
starved the thread that issues the card's kernels. The processes come from
a fork server, a single-threaded process started once, so no worker is
forked from a process that holds CUDA's, a checkpointer's or XLA's threads;
the dataset and the transform travel to each worker pickled.
"""
from __future__ import annotations

import functools
import multiprocessing
import os
import queue
import sys
import threading
import zipfile
from concurrent.futures import ProcessPoolExecutor
from typing import Callable, Iterator

import numpy as np

from cream_tpu_torch.data import native_pipe
from cream_tpu_torch.data.det_aug import sample_seed, train_transform
from cream_tpu_torch.data.image_io import read_rgb
from cream_tpu_torch.data.samplers import repeated_aug_order
from cream_tpu_torch.data.transforms import eval_preprocess_config, preprocess_pil

IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


class ZipReader:
    """Thread- and process-safe image-from-zip reader (MiniViT zipreader.py
    capability)."""

    def __init__(self, path: str):
        self.path = path
        self._local = threading.local()

    def __reduce__(self):
        return ZipReader, (self.path,)

    def _zf(self) -> zipfile.ZipFile:
        # one handle a thread and a process: a forked loader worker must not
        # share its parent's file offset
        if getattr(self._local, "pid", None) != os.getpid():
            self._local.zf = zipfile.ZipFile(self.path, "r")
            self._local.pid = os.getpid()
        return self._local.zf

    def namelist(self) -> list[str]:
        return self._zf().namelist()

    def read(self, name: str) -> bytes:
        return self._zf().read(name)

    def read_image(self, name: str) -> np.ndarray:
        return read_rgb(self.read(name))


class ImageFolder:
    """(path, class_id) listing from class-subdirectory layout."""

    def __init__(self, root: str, class_to_idx: dict | None = None):
        self.root = root
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        self.class_to_idx = class_to_idx or {c: i for i, c in enumerate(classes)}
        self.samples: list[tuple[str, int]] = []
        for c in classes:
            cdir = os.path.join(root, c)
            for f in sorted(os.listdir(cdir)):
                if f.lower().endswith(IMG_EXTS):
                    self.samples.append((os.path.join(cdir, f),
                                         self.class_to_idx[c]))

    def __len__(self):
        return len(self.samples)

    def load(self, i: int) -> tuple[np.ndarray, int]:
        path, label = self.samples[i]
        return read_rgb(path), label

    def load_bytes(self, i: int) -> tuple[bytes, int]:
        path, label = self.samples[i]
        with open(path, "rb") as fh:
            return fh.read(), label


def sub_imagenet(dataset: "ImageFolder", per_class: int = 100,
                 seed: int = 0) -> "ImageFolder":
    """Fixed per-class subset with the reference's exact membership.

    AutoFormer evolution evaluates candidates on EVO_IMNET — a subImageNet
    folder built once by lib/subImageNet.py: `random.seed(0)` then, per
    class in sorted order, `random.sample(sorted(os.listdir(class)), 100)`.
    This reproduces that selection in-place (same python-random sequence, no
    file copying)."""
    import copy
    import random

    rng = random.Random(seed)
    by_class: dict[int, list[tuple[str, int]]] = {}
    for path, label in dataset.samples:
        by_class.setdefault(label, []).append((path, label))
    sub = copy.copy(dataset)
    sub.samples = []
    for label in sorted(by_class):
        entries = sorted(by_class[label], key=lambda e: os.path.basename(e[0]))
        take = rng.sample(entries, min(per_class, len(entries)))
        sub.samples.extend(take)
    return sub


class ZipImageFolder:
    """ImageFolder over a zip archive: members named class/img.jpeg."""

    def __init__(self, zip_path: str):
        self.reader = ZipReader(zip_path)
        names = [n for n in self.reader.namelist()
                 if n.lower().endswith(IMG_EXTS)]
        classes = sorted({n.split("/")[0] for n in names})
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = [(n, self.class_to_idx[n.split("/")[0]])
                        for n in sorted(names)]

    def __len__(self):
        return len(self.samples)

    def load(self, i: int) -> tuple[np.ndarray, int]:
        name, label = self.samples[i]
        return self.reader.read_image(name), label

    def load_bytes(self, i: int) -> tuple[bytes, int]:
        name, label = self.samples[i]
        return self.reader.read(name), label


class IN22KDataset:
    """ImageNet-22k in TinyViT's layout (data/imagenet22k_dataset.py:14-68):
    `data_root/in22k_image_names.txt` lists image ids 'nXXXXXXXX_NNNN';
    each class lives in its own `data_root/nXXXXXXXX.zip` whose members are
    `{id}.jpeg`. Class ids = sorted wnid order (the 22k->1k remap in
    zoo/remap.py keys off the same ordering)."""

    def __init__(self, data_root: str, fname_format: str = "{}.jpeg"):
        self.data_root = data_root
        self.fname_format = fname_format
        info = os.path.join(data_root, "in22k_image_names.txt")
        folders: dict[str, list[str]] = {}
        with open(info) as fh:
            for iname in fh:
                iname = iname.strip()
                if not iname:
                    continue
                folders.setdefault(iname[:iname.index("_")], []).append(iname)
        class_names = sorted(folders)
        self.nb_classes = len(class_names)
        self.class_to_idx = {c: i for i, c in enumerate(class_names)}
        self.samples = [(iname, cid)
                        for cid, cname in enumerate(class_names)
                        for iname in folders[cname]]
        self._readers: dict[str, ZipReader] = {}

    def __len__(self):
        return len(self.samples)

    def _member(self, i: int) -> tuple[ZipReader, str, int]:
        iname, label = self.samples[i]
        cls = iname[:iname.index("_")]
        reader = self._readers.get(cls)
        if reader is None:
            reader = self._readers[cls] = ZipReader(
                os.path.join(self.data_root, cls + ".zip"))
        return reader, self.fname_format.format(iname), label

    def load(self, i: int) -> tuple[np.ndarray, int]:
        reader, name, label = self._member(i)
        return reader.read_image(name), label

    def load_bytes(self, i: int) -> tuple[bytes, int]:
        reader, name, label = self._member(i)
        return reader.read(name), label

    def get_keys(self) -> list[str]:
        return [s[0] for s in self.samples]


class SyntheticDataset:
    """Deterministic random images; for smoke tests and throughput runs.
    `load(i)` -> (uint8 (img_size, img_size, 3), int label), the JAX
    dataset's pixels and label."""

    def __init__(self, n: int = 1024, img_size: int = 224, num_classes: int = 1000):
        self.n, self.img_size, self.num_classes = n, img_size, num_classes

    def __len__(self):
        return self.n

    def load(self, i: int) -> tuple[np.ndarray, int]:
        rng = np.random.default_rng(i)
        arr = rng.integers(0, 256, (self.img_size, self.img_size, 3),
                           dtype=np.uint8)
        return arr, int(rng.integers(self.num_classes))


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


_WORKER_FN: Callable | None = None


def _init_worker(fn: Callable) -> None:
    global _WORKER_FN
    _WORKER_FN = fn


def _call_worker_fn(arg):
    return _WORKER_FN(arg)


_SERVER_LOCK = threading.Lock()
_SERVER_STARTED = False


def _worker_context():
    """The fork server's context. A worker re-runs the parent's main module
    as `__mp_main__`, as under `spawn`; the server preloads that module by
    name (a script by its file's stem, importable from its own directory)
    beside the recipe's modules, so the re-run finds its imports done and a
    worker starts in milliseconds, not in the seconds that importing torch
    takes. Python 3.12's own preload of a main script never takes effect,
    and 3.12.3's server does not take this process's sys.path, so the
    server is started here with sys.path as its PYTHONPATH.
    A script that runs a loader with workers keeps its work under
    `if __name__ == "__main__"`."""
    global _SERVER_STARTED
    from multiprocessing import forkserver

    ctx = multiprocessing.get_context("forkserver")
    with _SERVER_LOCK:
        if not _SERVER_STARTED:
            main = sys.modules.get("__main__")
            name = getattr(getattr(main, "__spec__", None), "name", None)
            if name is None and getattr(main, "__file__", None):
                name = os.path.splitext(os.path.basename(main.__file__))[0]
            ctx.set_forkserver_preload(
                [__name__, "cream_tpu_torch.data.auto_augment"]
                + ([name] if name and not name.endswith("__main__") else []))
            old = os.environ.get("PYTHONPATH")
            os.environ["PYTHONPATH"] = os.pathsep.join(p or os.getcwd() for p in sys.path)
            try:
                forkserver.ensure_running()
            finally:
                if old is None:
                    del os.environ["PYTHONPATH"]
                else:
                    os.environ["PYTHONPATH"] = old
            _SERVER_STARTED = True
    return ctx


class Workers:
    """`map(args)`: `fn` over `num_workers` worker processes from the fork
    server (`fn`, with its dataset and transform, pickled to each worker
    once; then only the args and the results cross a pipe), in order, each
    call's args split into one chunk a worker; in the calling thread for
    one worker. A context manager: leaving it stops the workers."""

    def __init__(self, fn: Callable, num_workers: int):
        self.fn, self.n = fn, max(int(num_workers), 1)
        self.pool = None
        if self.n > 1:
            self.pool = ProcessPoolExecutor(
                self.n, mp_context=_worker_context(),
                initializer=_init_worker, initargs=(fn,))

    def map(self, args) -> list:
        args = list(args)
        if self.pool is None:
            return [self.fn(a) for a in args]
        return list(self.pool.map(_call_worker_fn, args,
                                  chunksize=max(-(-len(args) // self.n), 1)))

    def __enter__(self) -> "Workers":
        return self

    def __exit__(self, *exc) -> None:
        if self.pool is not None:
            self.pool.shutdown(wait=True, cancel_futures=True)


class _EvalLoad:
    """An eval loader's worker function: index -> (float32 image, label)."""

    def __init__(self, dataset, cfg):
        self.dataset, self.cfg = dataset, cfg

    def __call__(self, i):
        img, label = self.dataset.load(i)
        return preprocess_pil(img, self.cfg), label


class _TrainLoad:
    """A train loader's worker function: (index, repeat) -> (float32 image,
    label, aug seed). The repeat id folds into the seed so repeated samples
    get distinct augmentations (the RASampler point)."""

    def __init__(self, dataset, transform, base_seed: int, epoch: int):
        self.dataset, self.transform = dataset, transform
        self.base_seed, self.epoch = base_seed, epoch

    def __call__(self, args):
        i, rep = args
        img, label = self.dataset.load(int(i))
        seed = sample_seed(self.base_seed + 101 * int(rep), self.epoch, int(i))
        return self.transform(img, seed), label, seed


def _use_native(dataset, native) -> bool:
    """Whether a loader takes the native pipeline for `dataset`
    (`native_pipe.use_native`: True raises where the library does not build
    or the dataset has no `load_bytes`; "auto" then takes the exact path)."""
    return native_pipe.use_native(
        native, None if hasattr(dataset, "load_bytes") else
        f"{type(dataset).__name__} has no load_bytes")


def _native_batch(dataset, idx, params_fn, out_size, mean, std, exact_fn,
                  n_threads, allow_prescale=True):
    """Decode a batch through native_pipe in the calling thread (the C++
    pool does the work, the GIL released); an image whose decode or parse
    fails (non-JPEG bytes, truncation) takes the exact path, `exact_fn(j)`
    of its batch position, so its pixels are the exact path's."""
    pairs = [dataset.load_bytes(int(i)) for i in idx]
    bufs = [p[0] for p in pairs]
    labels = np.asarray([p[1] for p in pairs], np.int32)
    wh = native_pipe.probe_sizes(bufs)
    params = params_fn(wh)
    images, status = native_pipe.decode_batch(
        bufs, params, out_size, mean, std, n_threads=n_threads,
        allow_prescale=allow_prescale)
    for j in np.nonzero((status != 0) | (wh[:, 0] <= 0))[0]:
        images[int(j)] = exact_fn(int(j))
    return images, labels


def eval_loader(dataset, batch_size: int, img_size: int = 224,
                crop: bool = True, clip_norm: bool = False,
                num_workers: int = 8, pad_final: bool = True,
                native=False, shard: tuple | None = None) -> Iterator[dict]:
    """Deterministic eval batches: each image resized (shorter side,
    bicubic) and centre-cropped to `img_size` (`crop`: from
    int(256/224 img_size), else from img_size), normalized with ImageNet's
    mean and std or, with `clip_norm`, OpenAI CLIP's. The final partial
    batch is padded with label = index = -1 (the eval step masks them), so
    every batch has one shape.

    native: False | True | "auto" — decode, resize and normalize through
    the C++ pipeline (`native_pipe`) in this thread, no worker process
    started; the size math is the exact path's, the resampling within ~1/255
    of it (no DCT prescale); an image the pipeline cannot decode takes the
    exact path. Keep False for golden-logit comparisons.
    shard: (process_index, process_count) — this host reads only its strided
    subset; batch_size is then per-host. Every host emits the SAME number of
    (padded) batches regardless of how the remainder falls."""
    cfg = eval_preprocess_config(img_size, crop=crop, clip=clip_norm)

    all_idx = np.arange(len(dataset))
    if shard is not None:
        # host-count-invariant step count: size of the largest host shard
        longest = -(-len(all_idx) // shard[1])
        n_steps = -(-longest // batch_size)
        all_idx = all_idx[shard[0]::shard[1]]
        pad_final = True
    else:
        n_steps = -(-len(all_idx) // batch_size)
    n = len(all_idx)
    load_one = _EvalLoad(dataset, cfg)
    use_native = _use_native(dataset, native)

    with Workers(load_one, 1 if use_native else num_workers) as pool:
        for k in range(n_steps):
            idx = all_idx[k * batch_size:min((k + 1) * batch_size, n)].tolist()
            if use_native and idx:
                images, labels = _native_batch(
                    dataset, idx, lambda wh: native_pipe.eval_params(wh, cfg),
                    cfg.crop, cfg.mean, cfg.std, lambda j: load_one(idx[j])[0],
                    num_workers, allow_prescale=False)
            else:
                results = pool.map(idx)
                images = (np.stack([r[0] for r in results]) if idx else
                          np.zeros((0, cfg.crop, cfg.crop, 3), np.float32))
                labels = np.asarray([r[1] for r in results], np.int32)
            index = np.asarray(idx, np.int32)
            if pad_final and len(idx) < batch_size:
                pad = batch_size - len(idx)
                images = np.concatenate(
                    [images, np.zeros((pad,) + images.shape[1:], images.dtype)])
                labels = np.concatenate([labels, -np.ones(pad, np.int32)])
                index = np.concatenate([index, -np.ones(pad, np.int32)])
            yield {"image": images, "label": labels, "index": index}


def train_loader(dataset, batch_size: int, epoch: int, base_seed: int = 0,
                 img_size: int = 224, num_workers: int = 8,
                 shuffle: bool = True, drop_last: bool = True,
                 mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225),
                 transform=None, repeated_aug: int = 0,
                 native=False, shard: tuple | None = None) -> Iterator[dict]:
    """Seeded training batches. Every sample carries its aug seed,
    `sample_seed(base_seed + 101 * repeat, epoch, index)`, so saved teacher
    logits can be replayed (TinyViT distillation semantics).

    transform: fn(uint8 RGB array, seed) -> float32 HWC (e.g.
    det_aug.make_train_transform for the full RandAugment recipe); defaults
    to the plain seeded RRC + flip + normalize at `img_size`. With
    `num_workers` > 1 it, like `dataset`, is pickled to the workers.
    native: False | True | "auto" — the plain RRC + flip pixels through the
    C++ pipeline (`native_pipe`) in this thread, no worker process started:
    the same seeded crop and flip decisions (`native_pipe.train_params`),
    DCT prescaling allowed; only with transform=None (the full RandAugment
    recipe stays on the exact path). An image the pipeline cannot decode
    takes the exact path.
    repeated_aug: >1 gives the RASampler order (AutoFormer/lib/samplers.py):
    each epoch visits ~n/reps distinct samples, each repeated `repeated_aug`
    times with different aug seeds; else the `default_rng(base_seed + epoch)`
    permutation (`shuffle`) or dataset order.
    shard: (process_index, process_count) — this host's strided slice of the
    epoch order, cut to an equal length on every host. The order/seeds are
    derived from (base_seed, epoch) BEFORE slicing, so the global sample/aug
    sequence is host-count-invariant."""
    if native and transform is not None:
        raise ValueError("native train path covers only the default "
                         "RRC+flip transform")
    n = len(dataset)
    if repeated_aug and repeated_aug > 1:
        order, reps = repeated_aug_order(n, epoch, base_seed, repeated_aug)
    else:
        order = np.arange(n)
        reps = np.zeros(n, np.int64)
        if shuffle:
            perm = np.random.default_rng(base_seed + epoch).permutation(n)
            order = order[perm]

    if shard is not None:
        per_host = len(order) // shard[1]
        order = order[shard[0]::shard[1]][:per_host]
        reps = reps[shard[0]::shard[1]][:per_host]

    if transform is None:
        transform = functools.partial(train_transform, size=img_size, mean=mean, std=std)

    m = len(order)
    end = m - (m % batch_size) if drop_last else m
    load_one = _TrainLoad(dataset, transform, base_seed, epoch)
    if _use_native(dataset, native):
        for start in range(0, end, batch_size):
            idx = order[start:start + batch_size]
            rr = reps[start:start + batch_size]
            seeds = [sample_seed(base_seed + 101 * int(r), epoch, int(i))
                     for i, r in zip(idx, rr)]
            images, labels = _native_batch(
                dataset, idx, lambda wh: native_pipe.train_params(wh, seeds, img_size),
                img_size, mean, std, lambda j: load_one((idx[j], rr[j]))[0],
                num_workers)
            yield {"image": images, "label": labels,
                   "index": np.asarray(idx, np.int32),
                   "seed": np.asarray(seeds, np.int32)}
        return
    with Workers(load_one, num_workers) as pool:
        for start in range(0, end, batch_size):
            idx = order[start:start + batch_size]
            rr = reps[start:start + batch_size]
            results = pool.map(zip(idx.tolist(), rr.tolist()))
            yield {
                "image": np.stack([r[0] for r in results]),
                "label": np.asarray([r[1] for r in results], np.int32),
                "index": np.asarray(idx, np.int32),
                "seed": np.asarray([r[2] for r in results], np.int32),
            }
