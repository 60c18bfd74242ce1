"""layout_pin: the identity, as a copy into a new row-major tensor.

Counterpart of the JAX package's `cream_tpu.ops.pallas.layout_pin.layout_pin`
(a Pallas identity copy with an identity backward, which forced XLA's
row-major layout on TinyViT's stage tensors). `layout_pin` is a
`torch.autograd.Function`: its forward launches the copy kernel in
`csrc/layout_pin.cu` (K11) on CUDA tensors and runs its plain version
`layout_pin_ref` (`x.clone()`) on CPU tensors; its backward returns the
incoming gradient unchanged, as JAX's `_bwd` does, with no copy.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

# kernel launches since import (or since a caller reset them)
LAUNCHES = 0


def layout_pin_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version of the forward: a copy."""
    return x.clone()


def layout_pin_copy(x: torch.Tensor) -> torch.Tensor:
    """A copy of x: K11 on CUDA tensors (contiguous x), `layout_pin_ref` on
    CPU tensors."""
    if x.device.type == "cpu":
        return layout_pin_ref(x)
    if x.device.type != "cuda":
        raise ValueError(f"no copy kernel for device {x.device}")
    if not x.is_contiguous():
        raise ValueError("layout_pin takes a contiguous tensor")
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    if x.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel()(x.data_ptr(), out.data_ptr(), x.numel() * x.element_size(), stream)
    if rc != 0:
        raise RuntimeError(f"layout_pin kernel launch failed: cudaError {rc}")
    global LAUNCHES
    LAUNCHES += 1
    return out


class LayoutPin(torch.autograd.Function):
    """Forward: `layout_pin_copy`; backward: the identity on dy."""

    @staticmethod
    def forward(ctx, x):
        return layout_pin_copy(x)

    @staticmethod
    def backward(ctx, dy):
        return dy


def layout_pin(x: torch.Tensor) -> torch.Tensor:
    """The identity, through a copy (see the module docstring)."""
    return LayoutPin.apply(x)


@lru_cache(maxsize=None)
def _kernel():
    from cream_tpu_torch.ops import build
    fn = build.load().cream_layout_pin
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
