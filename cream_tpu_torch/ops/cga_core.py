"""The attention core of EfficientViT's cascaded group attention, one head.

`cga_attention` has the contract of the JAX package's
`cream_tpu.ops.pallas.cga_core.cga_attention`: softmax(q·kᵀ·scale + bias)·v
per window. On CUDA tensors it launches the kernel in `csrc/cga_core.cu`
(K5: bf16 on the tensor cores, fp32 on the CUDA cores); on CPU tensors it
runs its plain PyTorch version `cga_attention_ref`. The TPU kernel's
block-diagonal packing of G windows (−1e9 cross terms) is a Mosaic schedule
choice the CUDA kernel does not need: it works per window, with four
16-token windows to a block.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from cream_tpu_torch.ops.common import aligned16

MAX_TOKENS = 64                       # tokens per window the kernel takes
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since import (or since a caller reset them)
LAUNCHES = 0


def cga_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      bias: torch.Tensor, scale: float) -> torch.Tensor:
    """Plain PyTorch version of `cga_attention`, with the numerics of the
    JAX package's `cga_core._kernel`: s = q·kᵀ in fp32, ·scale + bias
    (fp32); the exact row max, exp and division by the fp32 row sum; P
    rounded to v's dtype; P·V accumulated in fp32, rounded to q's dtype."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale + bias.float()
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = (e / e.sum(dim=-1, keepdim=True)).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


def _check(q, k, v, bias):
    if q.ndim != 3 or k.shape != q.shape or v.ndim != 3 or v.shape[:2] != q.shape[:2]:
        raise ValueError(f"q, k must be (W, N, kd) and v (W, N, d); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    N = q.shape[1]
    if tuple(bias.shape) != (N, N):
        raise ValueError(f"bias {tuple(bias.shape)} != {(N, N)}")


def cga_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias: torch.Tensor, scale: float) -> torch.Tensor:
    """q, k: (W, N, kd); v: (W, N, d); bias: (N, N) fp32, already gathered
    for this head. Returns softmax(q·kᵀ·scale + bias)·v as (W, N, d) in q's
    dtype: K5 on CUDA tensors (N ≤ 64, float32 or bfloat16, contiguous;
    copied first where they do not start on a 16-byte boundary),
    `cga_attention_ref` on CPU tensors."""
    _check(q, k, v, bias)
    if q.device.type == "cpu":
        return cga_attention_ref(q, k, v, bias, scale)
    if q.device.type != "cuda":
        raise ValueError(f"no CGA attention kernel for device {q.device}")
    W, N, kd = q.shape
    d = v.shape[-1]
    if N > MAX_TOKENS:
        raise ValueError(f"window of {N} tokens > {MAX_TOKENS}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"kernel takes float32 or bfloat16 q, k, v of one dtype, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if any(t.device != q.device for t in (k, v, bias)):
        raise ValueError("all inputs must be on q's device")
    q, k, v = (aligned16(t) for t in (q, k, v))      # 16-byte loads (bf16)
    bias = bias.to(torch.float32).contiguous()
    out = torch.empty((W, N, d), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                       out.data_ptr(), W, N, kd, d, _DTYPE_CODE[q.dtype],
                       float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"CGA attention kernel launch failed: cudaError {rc}")
    global LAUNCHES
    LAUNCHES += 1
    return out


@lru_cache(maxsize=None)
def _kernel():
    from cream_tpu_torch.ops import build
    fn = build.load().cream_cga_core
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn
