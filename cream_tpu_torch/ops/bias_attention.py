"""Per-window multi-head attention with a per-head bias table, forward only.

`fused_bias_attention` has the contract of the JAX package's
`cream_tpu.ops.pallas.bias_attention.fused_bias_attention`:
softmax(q·kᵀ·dk^-0.5 + bias[h])·v for q, k (W, h, N, dk), v (W, h, N, dv)
and bias (h, N, N). On CUDA tensors it launches the kernel in
`csrc/bias_attention.cu` (K3: bf16 on the tensor cores, fp32 on the CUDA
cores); on CPU tensors it runs its plain PyTorch version
`fused_bias_attention_ref`. The JAX wrapper pads N > 128 to a
multiple of 128 with a -1e9 bias, a Mosaic compile-time workaround that
changes nothing on the real rows; neither version here pads.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from cream_tpu_torch.ops.common import aligned16

MAX_TOKENS = 256                      # tokens per window the kernel takes
_SMEM_BYTES = 227 * 1024              # shared memory a Hopper block can use
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since import (or since a caller reset them)
LAUNCHES = 0


def _smem_bytes(N: int, dk: int, dv: int) -> int:
    """Shared memory of K3's block at one (window, head) in each of its two
    kernels, the larger: fp32 q, k (odd row stride) and v with the warps' P
    rows (CUDA cores), or bf16 q, k and v with rows and head dims padded to
    multiples of 16 and row strides 16 bytes over that (tensor cores)."""
    keys_per_lane = 2 if N <= 64 else 4 if N <= 128 else 8
    fp32 = 4 * (N * (dk + (dk | 1) + dv) + 4 * 32 * keys_per_lane)
    pad = lambda n: -(-n // 16) * 16
    bf16 = 2 * pad(N) * (2 * (pad(dk) + 8) + pad(dv) + 8)
    return max(fp32, bf16)


def supports_shape(N: int, dk: int, dv: int) -> bool:
    """Whether K3 takes windows of N tokens with head dims dk, dv: N <= 256
    and q, k, v of one (window, head) within a block's shared memory in
    either dtype's kernel."""
    return (1 <= N <= MAX_TOKENS and dk >= 1 and dv >= 1
            and _smem_bytes(N, dk, dv) <= _SMEM_BYTES)


def fused_bias_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of `fused_bias_attention`, with the numerics of
    the JAX package's `bias_attention._kernel`: s = q·kᵀ in fp32, then
    ·dk^-0.5, + bias (fp32); the exact row max, exp and division by the row
    sum; P rounded to v's dtype; P·V accumulated in fp32, rounded to q's
    dtype."""
    scale = q.shape[-1] ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale + bias.float()
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = (e / e.sum(dim=-1, keepdim=True)).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


def fused_bias_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bias: torch.Tensor) -> torch.Tensor:
    """q, k: (W, h, N, dk); v: (W, h, N, dv); bias: (h, N, N). Returns
    (W, h, N, dv) in q's dtype: K3 on CUDA tensors (`supports_shape`,
    float32 or bfloat16, contiguous; copied first where they do not start
    on a 16-byte boundary), `fused_bias_attention_ref` on CPU tensors."""
    if q.ndim != 4 or k.shape != q.shape or v.ndim != 4 or v.shape[:3] != q.shape[:3]:
        raise ValueError(f"q, k must be (W, h, N, dk) and v (W, h, N, dv); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    W, h, N, dk = q.shape
    dv = v.shape[-1]
    if tuple(bias.shape) != (h, N, N):
        raise ValueError(f"bias {tuple(bias.shape)} != {(h, N, N)}")
    if q.device.type == "cpu":
        return fused_bias_attention_ref(q, k, v, bias)
    if q.device.type != "cuda":
        raise ValueError(f"no bias-attention kernel for device {q.device}")
    if not supports_shape(N, dk, dv):
        raise ValueError(f"the bias-attention kernel does not take N={N}, dk={dk}, dv={dv}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"kernel takes float32 or bfloat16 q, k, v of one dtype, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if any(t.device != q.device for t in (k, v, bias)):
        raise ValueError("all inputs must be on q's device")
    q, k, v = (aligned16(t) for t in (q, k, v))      # 16-byte loads (bf16)
    bias = bias.to(torch.float32).contiguous()
    out = torch.empty((W, h, N, dv), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                       out.data_ptr(), W, h, N, dk, dv, _DTYPE_CODE[q.dtype],
                       float(dk ** -0.5), stream)
    if rc != 0:
        raise RuntimeError(f"bias-attention kernel launch failed: cudaError {rc}")
    global LAUNCHES
    LAUNCHES += 1
    return out


@lru_cache(maxsize=None)
def _kernel():
    from cream_tpu_torch.ops import build
    fn = build.load().cream_bias_attention
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn
