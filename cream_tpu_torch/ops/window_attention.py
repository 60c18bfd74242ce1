"""Window bias-attention directly on the NHWC qkv tensor, forward and backward.

`fused_window_attention` has the contract of the JAX package's
`cream_tpu.ops.pallas.window_attention.fused_window_attention`: it takes the
fused qkv projection output in its native (B, H, W, L) layout, does the
windowing itself, and writes (B, H, W, heads*dv) ready for the output
projection. It is differentiable through `FusedWindowAttention`, whose
forward is the kernel in `csrc/window_attention.cu` (K1) and whose backward
is the kernel in `csrc/window_attention_bwd.cu` (K2), as the JAX package's
custom_vjp pairs `_kernel` with `_bwd_kernel`. On CUDA tensors the kernels
run, their bf16 instantiations on the tensor cores and their fp32 ones on
the CUDA cores (the dtype picks, inside the kernels' C entry points); on CPU
tensors their plain PyTorch versions `window_attention_ref` and
`window_attention_bwd_ref` run instead.

Two lane packings of L:
  - "head_major": [q_h | k_h | v_h] per head (TinyViT/LeViT qkv)
  - "qkv_major":  [q all heads | k all heads | v all heads] (Swin lineage)
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch
from torch.autograd.function import once_differentiable

from cream_tpu_torch.ops.common import aligned16
from cream_tpu_torch.ops.window import window_partition, window_reverse

LAYOUTS = ("head_major", "qkv_major")
MAX_TOKENS = 256                      # window*window the kernels take
HEAD_DIMS = (16, 32, 64)              # kd and dv the kernels are built for
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# K2's per-group dbias partials are kept under this many bytes (see
# `_bwd_groups`)
_BWD_PARTIAL_BYTES = 64 << 20

# kernel launches since import (or since a caller reset them): K1, K2
LAUNCHES = 0
BWD_LAUNCHES = 0


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


def pack_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             layout: str) -> torch.Tensor:
    """Inverse of `split_qkv`: (..., heads, kd) x2 and (..., heads, dv) ->
    (..., heads*(2kd+dv)) in `layout`'s lane order."""
    if layout == "head_major":
        return torch.cat([q, k, v], dim=-1).flatten(-2)
    if layout == "qkv_major":
        return torch.cat([q.flatten(-2), k.flatten(-2), v.flatten(-2)], dim=-1)
    raise ValueError(f"unknown qkv layout: {layout}")


def _scores(q, k, bias, mask):
    """fp32 (Wn, h, N, N) scores q.k^T*scale + bias (+ mask per window
    position, windows ordered batch-major)."""
    Wn, N, h, kd = q.shape
    s = torch.einsum("bnhk,bmhk->bhnm", q.float(), k.float()) * (kd ** -0.5)
    s = s + bias.float()[None]
    if mask is not None:
        nwin = mask.shape[0]
        s = (s.view(Wn // nwin, nwin, h, N, N)
             + mask.float()[None, :, None]).view(Wn, h, N, N)
    return s


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           bias: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Per-window bias attention, plain PyTorch.

    q, k: (Wn, N, h, kd); v: (Wn, N, h, dv) in the compute dtype; bias
    (h, N, N); mask (nWin, N, N) per window position, windows ordered
    batch-major. fp32 scores and softmax, P rounded to the compute dtype,
    P.V accumulated in fp32. Returns (Wn, N, h*dv) in the compute dtype."""
    Wn, N = q.shape[:2]
    p = torch.softmax(_scores(q, k, bias, mask), dim=-1).to(q.dtype)
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


def window_attention_bwd_ref(qkv: torch.Tensor, bias: torch.Tensor,
                             mask: torch.Tensor | None, dout: torch.Tensor, *,
                             window: int, heads: int, kd: int, dv: int,
                             layout: str = "head_major",
                             qkv_bias: torch.Tensor | None = None):
    """Plain PyTorch version of K2, the backward of `fused_window_attention`.

    The math of the JAX package's `_bwd_kernel`, not autograd of the
    forward: the scores are recomputed in fp32 from the bias-folded qkv
    (rounded to qkv's dtype as in the forward); P is fp32, not rounded;
    dP = dO.V^T, dS = P*(dP - rowsum(dP*P)); dQ = dS.K*scale,
    dK = dS^T.Q*scale, dV = P^T.dO, accumulated in fp32 and packed per
    `layout` in qkv's dtype. Returns (dqkv (B, H, W, L) in qkv's dtype,
    dbias (heads, N, N) fp32 = dS summed over every window and image,
    d(qkv_bias) (L,) = the fp32 token sum of the rounded dqkv, in qkv's
    dtype, or None without a qkv bias). The mask gets no gradient."""
    B, H, W, _ = qkv.shape
    xb = qkv if qkv_bias is None else qkv + qkv_bias.to(qkv.dtype)
    w, padded = window_partition(xb, window)
    q, k, v = (t.float() for t in split_qkv(w, layout, heads, kd, dv))
    do = window_partition(dout, window)[0].unflatten(-1, (heads, dv)).float()
    p = torch.softmax(_scores(q, k, bias, mask), dim=-1)
    dp = torch.einsum("bnhd,bmhd->bhnm", do, v)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    scale = kd ** -0.5
    dq = torch.einsum("bhnm,bmhk->bnhk", ds, k) * scale
    dk = torch.einsum("bhnm,bnhk->bmhk", ds, q) * scale
    dvv = torch.einsum("bhnm,bnhd->bmhd", p, do)
    dw = pack_qkv(dq, dk, dvv, layout).to(qkv.dtype)
    dqkv = window_reverse(dw, window, padded, (H, W))
    dqb = None if qkv_bias is None else \
        dqkv.float().sum(dim=(0, 1, 2)).to(qkv.dtype)
    return dqkv, ds.sum(0), dqb


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


def _kernel_operands(qkv, bias, mask, qkv_bias, kd, dv, extra=()):
    """Checks what only the kernels need and returns qkv, bias, mask and
    qkv_bias as the kernels take them (qkv's dtype, fp32, fp32, qkv's dtype;
    contiguous; 16-byte aligned)."""
    if qkv.device.type != "cuda":
        raise ValueError(f"no window-attention kernel for device {qkv.device}")
    if qkv.dtype not in _DTYPE_CODE:
        raise TypeError(f"kernel takes float32 or bfloat16 qkv, got {qkv.dtype}")
    if kd not in HEAD_DIMS or dv not in HEAD_DIMS:
        raise ValueError(f"kernel is built for head dims {HEAD_DIMS}, "
                         f"got kd={kd}, dv={dv}")
    if not qkv.is_contiguous():
        raise ValueError("qkv must be contiguous")
    others = [t for t in (bias, mask, qkv_bias, *extra) if t is not None]
    if any(t.device != qkv.device for t in others):
        raise ValueError("all inputs must be on qkv's device")
    bias = aligned16(bias.to(torch.float32).contiguous())
    if mask is not None:
        mask = aligned16(mask.to(torch.float32).contiguous())
    if qkv_bias is not None:
        qkv_bias = aligned16(qkv_bias.to(qkv.dtype).contiguous())
    return aligned16(qkv), bias, mask, qkv_bias


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _forward(qkv, bias, mask, qkv_bias, *, window, heads, kd, dv, layout):
    """K1 on a CUDA tensor, its plain version on a CPU tensor."""
    if qkv.device.type == "cpu":
        return window_attention_ref(qkv, bias, mask, window=window,
                                    heads=heads, kd=kd, dv=dv, layout=layout,
                                    qkv_bias=qkv_bias)
    qkv, bias, mask, qkv_bias = _kernel_operands(qkv, bias, mask, qkv_bias, kd, dv)
    B, H, W, _ = qkv.shape
    out = torch.empty((B, H, W, heads * dv), dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel()(
            qkv.data_ptr(), bias.data_ptr(), _ptr(mask), _ptr(qkv_bias),
            out.data_ptr(), B, H, W, heads, kd, dv, window,
            LAYOUTS.index(layout), _DTYPE_CODE[qkv.dtype], kd ** -0.5, stream)
    if rc != 0:
        raise RuntimeError(f"window-attention kernel launch failed: "
                           f"cudaError {rc}")
    global LAUNCHES
    LAUNCHES += 1
    return out


def _bwd_groups(n_windows: int, heads: int, N: int, device) -> tuple[int, int]:
    """(windows per block, blocks per head) of a K2 launch.

    Each block walks a run of consecutive windows of one head and keeps its
    own fp32 dbias partial, so the sum over windows needs no atomics and
    comes out the same on every launch. Enough blocks to give every SM a
    full load of threads (counted in blocks of 8 warps), but partials under
    `_BWD_PARTIAL_BYTES` in all."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    target = sms * (2048 // 256)
    groups = max(1, min(n_windows, -(-target // heads),
                        _BWD_PARTIAL_BYTES // (heads * N * N * 4)))
    per_group = -(-n_windows // groups)
    return per_group, -(-n_windows // per_group)


def fused_window_attention_bwd(qkv: torch.Tensor, bias: torch.Tensor,
                               mask: torch.Tensor | None, dout: torch.Tensor,
                               *, window: int, heads: int, kd: int, dv: int,
                               layout: str = "head_major",
                               qkv_bias: torch.Tensor | None = None):
    """Backward of `fused_window_attention` for the cotangent `dout`
    (B, H, W, heads*dv). Returns (dqkv, dbias, d(qkv_bias) or None) as
    `window_attention_bwd_ref` does: K2 on a CUDA tensor, the plain version
    on a CPU tensor. dbias is the same bits on every launch."""
    _check(qkv, bias, mask, qkv_bias, window, heads, kd, dv, layout)
    B, H, W, _ = qkv.shape
    if tuple(dout.shape) != (B, H, W, heads * dv):
        raise ValueError(f"dout {tuple(dout.shape)} != {(B, H, W, heads * dv)}")
    if qkv.device.type == "cpu":
        return window_attention_bwd_ref(qkv, bias, mask, dout, window=window,
                                        heads=heads, kd=kd, dv=dv,
                                        layout=layout, qkv_bias=qkv_bias)
    qkv, bias, mask, qkv_bias = _kernel_operands(qkv, bias, mask, qkv_bias,
                                                 kd, dv, extra=(dout,))
    if dout.dtype != qkv.dtype:
        raise TypeError(f"dout is {dout.dtype}, qkv is {qkv.dtype}")
    if not dout.is_contiguous():
        raise ValueError("dout must be contiguous")
    dout = aligned16(dout)
    N = window * window
    n_windows = B * (H // window) * (W // window)
    per_group, groups = _bwd_groups(n_windows, heads, N, qkv.device)
    dqkv = torch.empty_like(qkv)
    dbias = torch.empty((heads, N, N), dtype=torch.float32, device=qkv.device)
    partial = torch.empty((groups, heads, N, N), dtype=torch.float32,
                          device=qkv.device)
    with torch.cuda.device(qkv.device):
        # the dK/dV sums go to device memory where a block's shared memory
        # cannot hold them (N = 256 with head dim 64)
        per_block = _bwd_scratch()(window, kd, dv)
        scratch = (torch.empty(groups * heads * per_block, dtype=torch.float32,
                               device=qkv.device) if per_block else None)
        stream = torch.cuda.current_stream().cuda_stream
        rc = _bwd_kernel()(
            qkv.data_ptr(), bias.data_ptr(), _ptr(mask), _ptr(qkv_bias),
            dout.data_ptr(), dqkv.data_ptr(), partial.data_ptr(),
            _ptr(scratch), dbias.data_ptr(), B, H, W, heads, kd, dv, window,
            LAYOUTS.index(layout), _DTYPE_CODE[qkv.dtype], per_group, groups,
            kd ** -0.5, stream)
    if rc != 0:
        raise RuntimeError(f"window-attention backward kernel launch failed: "
                           f"cudaError {rc}")
    global BWD_LAUNCHES
    BWD_LAUNCHES += 1
    # d(qkv bias) is the token sum of dqkv, outside the kernel as in JAX:
    # fp32 sums of the rounded dqkv, without an fp32 copy of it
    dqb = None if qkv_bias is None else \
        dqkv.sum(dim=(0, 1, 2), dtype=torch.float32).to(qkv.dtype)
    return dqkv, dbias, dqb


class FusedWindowAttention(torch.autograd.Function):
    """K1 forward, K2 backward (their plain versions on CPU tensors).

    Saves qkv before the bias fold, the gathered bias, the mask and the qkv
    bias; the backward recomputes P from them. The mask gets no gradient;
    bias and qkv_bias get theirs in their own dtypes."""

    @staticmethod
    def forward(ctx, qkv, bias, mask, qkv_bias, window, heads, kd, dv, layout):
        ctx.save_for_backward(qkv, bias, mask, qkv_bias)
        ctx.cfg = dict(window=window, heads=heads, kd=kd, dv=dv, layout=layout)
        return _forward(qkv, bias, mask, qkv_bias, **ctx.cfg)

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        qkv, bias, mask, qkv_bias = ctx.saved_tensors
        dqkv, dbias, dqb = fused_window_attention_bwd(
            qkv, bias, mask, dout.contiguous(), qkv_bias=qkv_bias, **ctx.cfg)
        need = ctx.needs_input_grad
        return (dqkv if need[0] else None,
                dbias.to(bias.dtype) if need[1] else None, None,
                dqb.to(qkv_bias.dtype) if need[3] else None,
                None, None, None, None, None)


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
    Returns (B, H, W, heads*dv) in qkv's dtype. Differentiable in qkv, bias
    and qkv_bias through `FusedWindowAttention`.
    """
    _check(qkv, bias, mask, qkv_bias, window, heads, kd, dv, layout)
    return FusedWindowAttention.apply(qkv, bias, mask, qkv_bias, window,
                                      heads, kd, dv, layout)


@lru_cache(maxsize=None)
def _kernel():
    from cream_tpu_torch.ops import build
    fn = build.load().cream_window_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@lru_cache(maxsize=None)
def _bwd_kernel():
    from cream_tpu_torch.ops import build
    fn = build.load().cream_window_attention_bwd
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 11
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@lru_cache(maxsize=None)
def _bwd_scratch():
    from cream_tpu_torch.ops import build
    fn = build.load().cream_window_attention_bwd_scratch
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    return fn
