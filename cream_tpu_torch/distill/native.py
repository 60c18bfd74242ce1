"""ctypes bindings for the native logits codec (`native/logits_codec.cc`).

Counterpart of `cream_tpu/distill/native.py`, with the same two entry
points. The port compiles its own copy of the source at first use with
`g++ -O3 -std=c++17 -fPIC -shared -lpthread` (no `-march=native`, so the
library runs on any x86-64 host) into `build/` at the root of the checkout,
named by a hash of the source and the flags, beside the CUDA kernels'
library. A failed build raises: a caller that asks for the native codec
gets it or an error, never the numpy path in its place.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from functools import lru_cache
from pathlib import Path

import numpy as np

from cream_tpu_torch.ops.build import BUILD_DIR

SOURCE = Path(__file__).resolve().parent.parent / "native" / "logits_codec.cc"
CXX = "g++"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"logits_codec-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the codec unless its library exists; returns its path."""
    path = library_path()
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [CXX, *CXX_FLAGS, "-o", str(tmp), str(SOURCE), "-lpthread"]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"building the logits codec failed: {' '.join(cmd)}: {e}") from e
    if res.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the logits codec failed: {' '.join(cmd)}\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, path)
    return path


@lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The codec's library, built if needed; one handle per process."""
    lib = ctypes.CDLL(str(build()))
    lib.logits_pack_write.restype = ctypes.c_int
    lib.logits_pack_write.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int,
        ctypes.c_int]
    lib.logits_read_unpack.restype = ctypes.c_int
    lib.logits_read_unpack.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_int, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int]
    return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def pack_write(fd: int, values: np.ndarray, indices: np.ndarray,
               seeds: np.ndarray, sample_idx: np.ndarray,
               n_threads: int = 8) -> None:
    """Pack B records (seed, K fp16 values, K int16 ids) and write each at
    sample_idx * record_size in the open file `fd`."""
    lib = load()
    values = np.ascontiguousarray(values, np.float32)
    indices = np.ascontiguousarray(indices, np.int32)
    seeds = np.ascontiguousarray(seeds, np.int32)
    sample_idx = np.ascontiguousarray(sample_idx, np.int64)
    B, K = values.shape
    if indices.shape != (B, K) or seeds.shape != (B,) or sample_idx.shape != (B,):
        raise ValueError(f"pack_write: shapes {values.shape}, {indices.shape}, "
                         f"{seeds.shape}, {sample_idx.shape}")
    rc = lib.logits_pack_write(fd, _ptr(values, ctypes.c_float),
                               _ptr(indices, ctypes.c_int32),
                               _ptr(seeds, ctypes.c_int32),
                               _ptr(sample_idx, ctypes.c_int64),
                               B, K, n_threads)
    if rc != 0:
        raise OSError("native logits_pack_write failed")


def read_unpack(fd: int, sample_idx: np.ndarray, K: int, n_threads: int = 8
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Read and unpack the records at `sample_idx`: (values (B, K) fp32,
    class ids (B, K) int32, seeds (B,) int32)."""
    lib = load()
    sample_idx = np.ascontiguousarray(sample_idx, np.int64)
    B = len(sample_idx)
    values = np.empty((B, K), np.float32)
    indices = np.empty((B, K), np.int32)
    seeds = np.empty((B,), np.int32)
    rc = lib.logits_read_unpack(fd, _ptr(sample_idx, ctypes.c_int64), B, K,
                                _ptr(values, ctypes.c_float),
                                _ptr(indices, ctypes.c_int32),
                                _ptr(seeds, ctypes.c_int32), n_threads)
    if rc != 0:
        raise OSError("native logits_read_unpack failed")
    return values, indices, seeds
