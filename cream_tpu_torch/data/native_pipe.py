"""ctypes bindings for the native C++ image pipeline (`native/image_pipe.cc`).

Counterpart of `cream_tpu/data/native_pipe.py`, with its entry points and
their meanings: JPEG decode (DCT-domain prescaling when heavily
downscaling), Pillow-algorithm antialiased bicubic resampling,
crop/flip/normalize, all in a C++ thread pool, one call per batch. Python
keeps every seeded *decision* (sample order, RRC boxes, flip coins:
`data/det_aug.py`; the eval size math: `data/transforms.py`), so a batch's
crops and flips are those of the exact path; only the resampling arithmetic
differs (fp32 against Pillow's fixed point, within ~1/255 a channel).

The port compiles its own copy of the source at first use with
`g++ -O3 -march=native -std=c++17 -fPIC -shared` into `build/` at the root
of the checkout, against the libjpeg-turbo 2.1.5 headers copied beside the
source (libjpeg's version-62 API) and linked with the host's libjpeg.so.62:
the system's, else the one Pillow's wheel bundles (`jpeg_library`; the
H100 machine has no libjpeg headers and no system libjpeg). The library is
named by a hash of the sources, the compiler, the flags, the libjpeg it
links and the host's CPU (`cpu_id`: `-march=native` code must not run on
another CPU, so a `build/` copied to another host builds anew). A failed
build raises with the compiler's output (`load`); `available()` says
whether the library builds and loads here.

Loaders fall back per image to the exact path (`image_io.read_rgb` +
`pil_ops`) where the returned status is not 0 (PNG, WebP, truncated bytes).
The exact-replay distillation contract (saved teacher logits keyed by aug
seed) pins the exact path; the native path is the throughput option for
runs that do not replay logits across loader implementations.
"""
from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import logging
import os
import platform
import subprocess
from functools import lru_cache
from pathlib import Path

import numpy as np

from cream_tpu_torch.ops.build import BUILD_DIR

NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
SOURCE = NATIVE_DIR / "image_pipe.cc"
# libjpeg-turbo 2.1.5's headers, copied beside the source (version-62 API)
HEADERS = ("jpeglib.h", "jmorecfg.h", "jerror.h", "jconfig.h")
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall", "-shared")

_FILTERS = {"bilinear": 1, "bicubic": 2}
# build failures by library path: "auto" does not rerun a compiler that failed
_FAILED: dict[Path, str] = {}
log = logging.getLogger(__name__)


@lru_cache(maxsize=None)
def cpu_id() -> str:
    """What `-march=native` compiles for: the vendor, model name and
    feature flags of `/proc/cpuinfo`'s first CPU, else the platform's."""
    keys = ("vendor_id", "model name", "flags")
    found = {}
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                key = line.split(":", 1)[0].strip()
                if key in keys and key not in found:
                    found[key] = line.split(":", 1)[1].strip()
                if len(found) == len(keys) or not line.strip():
                    break
    except OSError:
        pass
    return " | ".join(found.values()) or f"{platform.machine()} {platform.processor()}"


@lru_cache(maxsize=None)
def jpeg_library() -> str:
    """The libjpeg.so.62 the pipeline links, as a linker argument: the
    system's where the dynamic linker's cache has it, else the one Pillow's
    wheel bundles (`pillow.libs/libjpeg-*.so.62*`, found without importing
    Pillow); "" where neither is present."""
    try:
        res = subprocess.run(["ldconfig", "-p"], capture_output=True, text=True)
        if any(line.split()[0] == "libjpeg.so.62" for line in res.stdout.splitlines()[1:]
               if line.split()):
            return "-l:libjpeg.so.62"
    except OSError:
        pass
    spec = importlib.util.find_spec("PIL")
    for loc in (spec.submodule_search_locations or []) if spec else []:
        found = sorted((Path(loc).parent / "pillow.libs").glob("libjpeg-*.so.62*"))
        if found:
            return str(found[0])
    return ""


def _link_args() -> list[str]:
    lib = jpeg_library()
    if not lib:
        raise RuntimeError("building the native image pipeline failed: no libjpeg.so.62 "
                           "(neither the system's nor Pillow's bundled one)")
    if lib.startswith("-l"):
        return [lib, "-lpthread"]
    return [lib, f"-Wl,-rpath,{Path(lib).parent}", "-lpthread"]


def library_path() -> Path:
    h = hashlib.sha256(" ".join((CXX, *CXX_FLAGS, jpeg_library(), cpu_id())).encode())
    for name in ("image_pipe.cc", *HEADERS):
        h.update((NATIVE_DIR / name).read_bytes())
    return BUILD_DIR / f"image_pipe-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the pipeline unless its library exists; returns its path.
    Raises RuntimeError with the compiler's output when the build fails."""
    path = library_path()
    if path.exists():
        return path
    if path in _FAILED:
        raise RuntimeError(_FAILED[path])
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [CXX, *CXX_FLAGS, f"-I{NATIVE_DIR}", "-o", str(tmp), str(SOURCE), *_link_args()]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        out = "" if res.returncode == 0 else f"\n{res.stdout}{res.stderr}"
    except OSError as e:
        out = f": {e}"
    if out:
        tmp.unlink(missing_ok=True)
        _FAILED[path] = f"building the native image pipeline failed: {' '.join(cmd)}{out}"
        raise RuntimeError(_FAILED[path])
    os.replace(tmp, path)
    return path


@lru_cache(maxsize=None)
def _open(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.ip_sizes.restype = ctypes.c_int
    lib.ip_sizes.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int, ctypes.POINTER(ctypes.c_int32)]
    lib.ip_batch.restype = ctypes.c_int
    lib.ip_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int, ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32)]
    return lib


def load() -> ctypes.CDLL:
    """The pipeline's library, built if needed; one handle per process."""
    return _open(build())


def available() -> bool:
    """Whether the library builds (or is built) and loads here."""
    try:
        load()
    except (RuntimeError, OSError):
        return False
    return True


def use_native(native, missing: str | None = None) -> bool:
    """The loaders' choice of path. `native`: False (the exact path), True
    (the native path; raises with the compiler's output where the library
    does not build, or with `missing` where the data cannot take it) or
    "auto" (the native path where it can run, else the exact path: the
    choice is logged once a call)."""
    if not (native is False or native is True or native == "auto"):
        raise ValueError(f"native={native!r}: expected False, True or 'auto'")
    if native is False:
        return False
    if native is True:
        if missing:
            raise RuntimeError(f"native=True: {missing}")
        load()
        return True
    reason = missing
    if reason is None:
        try:
            load()
        except (RuntimeError, OSError) as e:
            reason = str(e).splitlines()[0]
    if reason:
        log.warning("native='auto': the exact (Python) image path: %s", reason)
        return False
    log.info("native='auto': the native image pipeline (%s)", library_path().name)
    return True


def _buf_arrays(bufs: list) -> tuple:
    for b in bufs:
        if not isinstance(b, bytes):
            raise TypeError(f"image buffers must be bytes, got {type(b).__name__}")
    n = len(bufs)
    arr = (ctypes.c_char_p * n)(*bufs)
    lens = np.asarray([len(b) for b in bufs], np.int64)
    # arr and lens travel with the pointers: the caller keeps them alive
    return (ctypes.cast(arr, ctypes.POINTER(ctypes.c_char_p)),
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), arr, lens)


def probe_sizes(bufs: list) -> np.ndarray:
    """(n, 2) int32 of (width, height) per JPEG; (0, 0) = unparseable."""
    lib = load()
    n = len(bufs)
    wh = np.zeros((n, 2), np.int32)
    bp, lp, _keep_arr, _keep_lens = _buf_arrays(bufs)
    lib.ip_sizes(bp, lp, n, wh.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return wh


def decode_batch(bufs: list, params: np.ndarray, out_size: int,
                 mean, std, filter: str = "bicubic",
                 n_threads: int = 0, allow_prescale: bool = True) -> tuple:
    """Decode + geometry + normalize a batch.

    params: (n, 9) int32 rows (x0, y0, box_w, box_h, resample_w, resample_h,
    crop_x, crop_y, flip) in full-resolution source coordinates.
    allow_prescale: permit DCT-domain reduced decode when heavily
    downscaling (big speedup; diverges further from Pillow on
    high-frequency content — disable for parity-critical eval).
    Returns (images (n, out, out, 3) float32, status (n,) int32 — 0 ok).
    The call releases the GIL while the C++ pool works."""
    lib = load()
    n = len(bufs)
    params = np.ascontiguousarray(params, np.int32)
    if params.shape != (n, 9):
        raise ValueError(f"params must be ({n}, 9), got {params.shape}")
    if filter not in _FILTERS:
        raise ValueError(f"filter must be one of {tuple(_FILTERS)}, got {filter!r}")
    out = np.empty((n, out_size, out_size, 3), np.float32)
    status = np.zeros(n, np.int32)
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    if mean.shape != (3,) or std.shape != (3,):
        raise ValueError("mean and std take 3 values")
    if n_threads <= 0:
        n_threads = min(32, (os.cpu_count() or 1) * 2)
    bp, lp, _keep_arr, _keep_lens = _buf_arrays(bufs)
    rc = lib.ip_batch(
        bp, lp, n,
        params.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out_size, out_size, _FILTERS[filter], int(allow_prescale),
        mean.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        std.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n_threads,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if rc != 0:
        status[:] = 99
    return out, status


def eval_params(wh: np.ndarray, cfg) -> np.ndarray:
    """Per-image eval geometry rows (shorter-side resize + center crop),
    `transforms.preprocess_pil`'s size math."""
    from cream_tpu_torch.data.transforms import crop_offsets, resize_size

    n = wh.shape[0]
    params = np.zeros((n, 9), np.int32)
    for i, (w, h) in enumerate(wh):
        if w <= 0 or h <= 0:
            continue
        nw, nh = resize_size(int(w), int(h), cfg.resize_shorter)
        left, top = crop_offsets(nw, nh, cfg.crop)
        params[i] = (0, 0, w, h, nw, nh, left, top, 0)
    return params


def train_params(wh: np.ndarray, seeds, size: int, scale=(0.08, 1.0),
                 ratio=(3 / 4, 4 / 3), hflip: float = 0.5) -> np.ndarray:
    """Per-image seeded RRC + flip geometry: the draws of
    `det_aug.train_transform` in its order (box, then the flip coin), so a
    given (image, seed) pair crops and flips as on the exact path."""
    from cream_tpu_torch.data.det_aug import rrc_box

    n = wh.shape[0]
    params = np.zeros((n, 9), np.int32)
    for i, (w, h) in enumerate(wh):
        if w <= 0 or h <= 0:
            continue
        rng = np.random.default_rng(int(seeds[i]))
        x0, y0, bw, bh = rrc_box(int(w), int(h), rng, scale, ratio)
        flip = 1 if rng.random() < hflip else 0  # always drawn, as train_transform does
        params[i] = (x0, y0, bw, bh, size, size, 0, 0, flip)
    return params
