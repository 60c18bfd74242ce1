"""Build the package's CUDA sources with nvcc at first use and load them.

Every `csrc/*.cu` file is compiled, with a plain C interface, by its own
nvcc process (all started together) and the objects are linked into one
shared library for Hopper (`sm_90a`) under `build/` at the root of the
checkout, named by a hash of the sources and flags, so an edited source
rebuilds and an unchanged one is loaded as it is. The library is opened with
ctypes; each kernel module declares its functions' `argtypes`. A failed
build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from functools import lru_cache
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"cream_tpu_torch_kernels-{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        from torch.utils.cpp_extension import CUDA_HOME
        if CUDA_HOME:
            nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    if nvcc is None or not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def build() -> Path:
    """Compile the sources unless the library for them exists; returns its
    path. nvcc's report (registers, shared memory, spills) is kept beside it
    as `<library>.log`."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{path.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources()]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for src, obj in zip(sources(), objs)]
    logs = [f"== {src.name}\n{proc.communicate()[0]}"
            for src, proc in zip(sources(), procs)]
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    failed = [src.name for src, proc in zip(sources(), procs) if proc.returncode]
    if not failed:
        res = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                             capture_output=True, text=True)
        logs.append(f"== link\n{res.stdout}{res.stderr}")
        if res.returncode:
            failed = ["link"]
    for obj in objs:
        obj.unlink(missing_ok=True)
    log = "\n".join(logs)
    path.with_suffix(".so.log").write_text(log)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{log}")
    os.replace(tmp, path)
    return path


@lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The kernels' library, built if needed; one handle per process."""
    return ctypes.CDLL(str(build()))
