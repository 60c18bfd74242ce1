"""Window partition and reverse of whole windows, as copy kernels.

`window_partition_kernel` and `window_reverse_kernel` have the contract of
the JAX package's `cream_tpu.ops.pallas.window_relayout`
`window_partition_pallas` / `window_reverse_pallas`: (B, H, W, C) <->
(B*nH*nW, window*window, C) for H and W multiples of the window; a ragged map
raises ValueError. On CUDA tensors they launch the kernels in
`csrc/window_relayout.cu` (K10); on CPU tensors they run the plain versions
`window_partition_ref` / `window_reverse_ref`, which are `ops/window.py`'s
functions on whole windows. Every result is a new contiguous tensor.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from cream_tpu_torch.ops.window import window_partition, window_reverse

# kernel launches since import (or since a caller reset them)
LAUNCHES = 0


def _check_whole(H: int, W: int, window: int) -> None:
    if window < 1 or H < window or W < window or H % window or W % window:
        raise ValueError(f"map {H}x{W} is not made of whole {window}x{window} windows")


def window_partition_ref(x: torch.Tensor, window: int) -> torch.Tensor:
    """Plain version of `window_partition_kernel`."""
    _check_whole(x.shape[1], x.shape[2], window)
    return window_partition(x, window)[0]


def window_reverse_ref(windows: torch.Tensor, window: int,
                       hw: tuple[int, int]) -> torch.Tensor:
    """Plain version of `window_reverse_kernel`."""
    H, W = hw
    _check_whole(H, W, window)
    return window_reverse(windows, window, (H, W), (H, W))


def _vec_bytes(row_bytes: int, *ptrs: int) -> int:
    """The widest access, up to 16 bytes, that divides a pixel's bytes and
    both pointers."""
    for v in (16, 8, 4, 2):
        if row_bytes % v == 0 and all(p % v == 0 for p in ptrs):
            return v
    raise ValueError(f"pixels of {row_bytes} bytes: the kernel moves 2-byte units at least")


def _launch(src: torch.Tensor, out: torch.Tensor, reverse: bool, B: int, H: int,
            W: int, window: int) -> torch.Tensor:
    if src.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f"kernel moves float32, bfloat16 or float16 tensors, got {src.dtype}")
    if not src.is_contiguous():
        raise ValueError("the input must be contiguous")
    row = src.shape[-1] * src.element_size()
    vec = _vec_bytes(row, src.data_ptr(), out.data_ptr())
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel()(src.data_ptr(), out.data_ptr(), int(reverse), B, H, W, window,
                       row, vec, stream)
    if rc != 0:
        raise RuntimeError(f"window relayout kernel launch failed: cudaError {rc}")
    global LAUNCHES
    LAUNCHES += 1
    return out


def window_partition_kernel(x: torch.Tensor, window: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nH*nW, window*window, C), H and W multiples of
    `window`: K10 on CUDA tensors, `window_partition_ref` on CPU tensors."""
    B, H, W, C = x.shape
    _check_whole(H, W, window)
    if x.device.type == "cpu":
        return window_partition_ref(x, window)
    if x.device.type != "cuda":
        raise ValueError(f"no window relayout kernel for device {x.device}")
    out = torch.empty((B * (H // window) * (W // window), window * window, C),
                      dtype=x.dtype, device=x.device)
    return _launch(x, out, False, B, H, W, window)


def window_reverse_kernel(windows: torch.Tensor, window: int,
                          hw: tuple[int, int]) -> torch.Tensor:
    """(B*nH*nW, window*window, C) -> (B, H, W, C), the inverse of
    `window_partition_kernel`: K10 on CUDA tensors, `window_reverse_ref` on
    CPU tensors."""
    H, W = hw
    _check_whole(H, W, window)
    Wn, N, C = windows.shape
    n_win = (H // window) * (W // window)
    if N != window * window or Wn % n_win:
        raise ValueError(f"windows {tuple(windows.shape)} do not tile a {H}x{W} map "
                         f"with window {window}")
    if windows.device.type == "cpu":
        return window_reverse_ref(windows, window, hw)
    if windows.device.type != "cuda":
        raise ValueError(f"no window relayout kernel for device {windows.device}")
    out = torch.empty((Wn // n_win, H, W, C), dtype=windows.dtype, device=windows.device)
    return _launch(windows, out, True, Wn // n_win, H, W, window)


@lru_cache(maxsize=None)
def _kernel():
    from cream_tpu_torch.ops import build
    fn = build.load().cream_window_relayout
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
