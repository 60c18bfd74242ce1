"""Window bias-attention directly on the NHWC qkv tensor.

`fused_window_attention` has the contract of the JAX package's
`cream_tpu.ops.pallas.window_attention.fused_window_attention` (forward):
it takes the fused qkv projection output in its native (B, H, W, L) layout,
does the windowing itself, and writes (B, H, W, heads*dv) ready for the
output projection. On a CUDA tensor it launches the hand-written kernel in
`csrc/window_attention.cu`; on a CPU tensor it runs `window_attention_ref`,
the plain PyTorch version of the same function.

Two lane packings of L:
  - "head_major": [q_h | k_h | v_h] per head (TinyViT/LeViT qkv)
  - "qkv_major":  [q all heads | k all heads | v all heads] (Swin lineage)
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from cream_tpu_torch.ops.window import window_partition, window_reverse

LAYOUTS = ("head_major", "qkv_major")
MAX_TOKENS = 256                      # window*window the kernel takes
HEAD_DIMS = (16, 32, 64)              # kd and dv the kernel is built for
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since import (or since a caller reset it)
LAUNCHES = 0


def split_qkv(w: torch.Tensor, layout: str, heads: int, kd: int, dv: int):
    """(..., heads*(2kd+dv)) -> q, k (..., heads, kd) and v (..., heads, dv)."""
    lead = w.shape[:-1]
    if layout == "head_major":
        w = w.reshape(*lead, heads, 2 * kd + dv)
        return w.split([kd, kd, dv], dim=-1)
    if layout == "qkv_major":
        q, k, v = w.split([heads * kd, heads * kd, heads * dv], dim=-1)
        return (q.reshape(*lead, heads, kd), k.reshape(*lead, heads, kd),
                v.reshape(*lead, heads, dv))
    raise ValueError(f"unknown qkv layout: {layout}")


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           bias: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Per-window bias attention, plain PyTorch.

    q, k: (Wn, N, h, kd); v: (Wn, N, h, dv) in the compute dtype; bias
    (h, N, N); mask (nWin, N, N) per window position, windows ordered
    batch-major. fp32 scores and softmax, P rounded to the compute dtype,
    P.V accumulated in fp32. Returns (Wn, N, h*dv) in the compute dtype."""
    Wn, N, h, kd = q.shape
    s = torch.einsum("bnhk,bmhk->bhnm", q.float(), k.float()) * (kd ** -0.5)
    s = s + bias.float()[None]
    if mask is not None:
        nwin = mask.shape[0]
        s = (s.view(Wn // nwin, nwin, h, N, N)
             + mask.float()[None, :, None]).view(Wn, h, N, N)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bhnm,bmhd->bnhd", p.float(), v.float()).to(q.dtype)
    return o.reshape(Wn, N, -1)


def window_attention_ref(qkv: torch.Tensor, bias: torch.Tensor,
                         mask: torch.Tensor | None = None, *, window: int,
                         heads: int, kd: int, dv: int,
                         layout: str = "head_major",
                         qkv_bias: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of `fused_window_attention` (same arguments)."""
    B, H, W, _ = qkv.shape
    if qkv_bias is not None:
        qkv = qkv + qkv_bias.to(qkv.dtype)
    w, padded = window_partition(qkv, window)
    q, k, v = split_qkv(w, layout, heads, kd, dv)
    return window_reverse(attend(q, k, v, bias, mask), window, padded, (H, W))


def _check(qkv, bias, mask, qkv_bias, window, heads, kd, dv, layout):
    if qkv.ndim != 4:
        raise ValueError(f"qkv must be (B, H, W, L), got {tuple(qkv.shape)}")
    B, H, W, L = qkv.shape
    if H % window or W % window:
        raise ValueError(f"H={H}, W={W} are not multiples of window={window}")
    N = window * window
    if N > MAX_TOKENS:
        raise ValueError(f"window {window} has {N} tokens > {MAX_TOKENS}")
    if layout not in LAYOUTS:
        raise ValueError(f"unknown qkv layout: {layout}")
    if L != heads * (2 * kd + dv):
        raise ValueError(f"L={L} != heads*(2*kd+dv) = {heads * (2 * kd + dv)}")
    if tuple(bias.shape) != (heads, N, N):
        raise ValueError(f"bias {tuple(bias.shape)} != {(heads, N, N)}")
    nwin = (H // window) * (W // window)
    if mask is not None and tuple(mask.shape) != (nwin, N, N):
        raise ValueError(f"mask {tuple(mask.shape)} != {(nwin, N, N)}")
    if qkv_bias is not None and tuple(qkv_bias.shape) != (L,):
        raise ValueError(f"qkv_bias {tuple(qkv_bias.shape)} != {(L,)}")


def fused_window_attention(qkv: torch.Tensor, bias: torch.Tensor,
                           mask: torch.Tensor | None = None, *, window: int,
                           heads: int, kd: int, dv: int,
                           layout: str = "head_major",
                           qkv_bias: torch.Tensor | None = None) -> torch.Tensor:
    """Windowed multi-head bias-attention without any transpose in memory.

    qkv:  (B, H, W, heads*(2*kd+dv)), lanes packed per `layout`; H and W
          multiples of `window`, window**2 <= 256.
    bias: (heads, N, N) per-offset attention bias, N = window**2 (fp32).
    mask: optional (nH*nW, N, N) additive mask per window position (Swin
          shifted windows).
    qkv_bias: optional (L,) qkv projection bias, added to q/k/v in the kernel
          (the caller's qkv GEMM then runs without its bias).
    Returns (B, H, W, heads*dv) in qkv's dtype. Forward only.
    """
    _check(qkv, bias, mask, qkv_bias, window, heads, kd, dv, layout)
    if qkv.device.type == "cpu":
        return window_attention_ref(qkv, bias, mask, window=window,
                                    heads=heads, kd=kd, dv=dv, layout=layout,
                                    qkv_bias=qkv_bias)
    if qkv.device.type != "cuda":
        raise ValueError(f"no window-attention kernel for device {qkv.device}")
    if qkv.dtype not in _DTYPE_CODE:
        raise TypeError(f"kernel takes float32 or bfloat16 qkv, got {qkv.dtype}")
    if kd not in HEAD_DIMS or dv not in HEAD_DIMS:
        raise ValueError(f"kernel is built for head dims {HEAD_DIMS}, "
                         f"got kd={kd}, dv={dv}")
    if not qkv.is_contiguous():
        raise ValueError("qkv must be contiguous")
    others = [t for t in (bias, mask, qkv_bias) if t is not None]
    if torch.is_grad_enabled() and any(t.requires_grad for t in [qkv, *others]):
        raise NotImplementedError("the window-attention kernel is forward "
                                  "only: call it under torch.inference_mode()")
    if any(t.device != qkv.device for t in others):
        raise ValueError("all inputs must be on qkv's device")
    bias = bias.to(torch.float32).contiguous()
    if mask is not None:
        mask = mask.to(torch.float32).contiguous()
    if qkv_bias is not None:
        qkv_bias = qkv_bias.to(qkv.dtype).contiguous()
    B, H, W, _ = qkv.shape
    out = torch.empty((B, H, W, heads * dv), dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel()(
            qkv.data_ptr(), bias.data_ptr(),
            None if mask is None else mask.data_ptr(),
            None if qkv_bias is None else qkv_bias.data_ptr(),
            out.data_ptr(), B, H, W, heads, kd, dv, window,
            LAYOUTS.index(layout), _DTYPE_CODE[qkv.dtype], kd ** -0.5, stream)
    if rc != 0:
        raise RuntimeError(f"window-attention kernel launch failed: "
                           f"cudaError {rc}")
    global LAUNCHES
    LAUNCHES += 1
    return out


@lru_cache(maxsize=None)
def _kernel():
    from cream_tpu_torch.ops import build
    fn = build.load().cream_window_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn
