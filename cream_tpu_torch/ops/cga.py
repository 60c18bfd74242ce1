"""EfficientViT's cascaded group attention as one fused op (eval, BN folded).

`fused_cga` has the contract of the JAX package's
`cream_tpu.ops.pallas.cga.fused_cga`: the whole cascade of every window,
from x to the output projection, with the per-head ConvBNs folded into
weights by `fold_cga_variables`. On CUDA tensors it launches the kernel in
`csrc/cga.cu` (K4); on CPU tensors it runs its plain PyTorch version
`fused_cga_ref`. The TPU kernel padded ws 7 -> 8 with a −1e9 key bucket and
a query mask (a Mosaic layout rule); the CUDA kernel takes the N = ws²
tokens as they are. Its bfloat16 path takes G windows a block, G from
`launch_plan`, which mirrors the kernel's own plan (`cream_cga_plan`).
"""
from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import NamedTuple

import torch
import torch.nn.functional as F

from cream_tpu_torch.ops.common import aligned16
from cream_tpu_torch.ops.fuse import fold_convbn

MAX_TOKENS = 64                       # tokens per window the kernel takes
SMEM_LIMIT = 232448                   # shared memory one block may use (H100)
SMEM_PAIR = 115712                    # a block's share when two blocks share an SM
MAX_WINDOWS = 8                       # windows a bfloat16 block takes
SMS = 132                             # the H100's SMs (the plan fills waves of two blocks an SM)
# csrc/cga.cu's bfloat16 constants: warps a block, 16x16 output tiles a warp
# holds in one pass of a product, weight rows a ring slot holds
_WARPS, _UNITS, _CHUNK = 8, 9, 32
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since import (or since a caller reset them)
LAUNCHES = 0


def _bias_table(biases: torch.Tensor, idxs) -> torch.Tensor:
    """(heads, n_off) offset table -> (heads, N, N) fp32 through the (N, N)
    bucket ids (a numpy array is copied to the table's device; pass a tensor
    already there to keep the host from waiting on that copy)."""
    idxs = torch.as_tensor(idxs, dtype=torch.long, device=biases.device)
    return biases.float()[:, idxs]


def fused_cga_ref(x: torch.Tensor, biases: torch.Tensor, idxs, wqkv, bqkv, dwk,
                  dwb, wproj, bproj, *, ws: int, heads: int, c_in: int, kd: int,
                  d: int, ks_max: int) -> torch.Tensor:
    """Plain PyTorch version of `fused_cga` (same arguments), with the
    numerics of the JAX package's `cga._kernel`: the cascade add in x's
    dtype; qkv accumulated in fp32 + bqkv, rounded; the depthwise ks_max²
    conv on q in fp32 over a zero ring, times kd^-0.5, rounded; fp32 scores
    + bias and softmax, P rounded, P·V in fp32, rounded; ReLU of the
    concatenated heads, the projection in fp32 + bproj, rounded."""
    Nw, C, dt = x.shape[0], x.shape[-1], x.dtype
    N, pad, scale = ws * ws, ks_max // 2, kd ** -0.5
    rows = x.reshape(Nw, N, C)
    bias = _bias_table(biases, idxs)
    feat, outs = rows[..., :c_in], []
    for i in range(heads):
        if i > 0:
            feat = feat + rows[..., i * c_in:(i + 1) * c_in]
        qkv = (torch.matmul(feat.float(), wqkv[i].float()) + bqkv[i].float()).to(dt)
        q, k, v = qkv.split([kd, kd, d], dim=-1)
        qp = F.pad(q.float().reshape(Nw, ws, ws, kd), (0, 0, pad, pad, pad, pad))
        acc = dwb[i].float().expand(Nw, ws, ws, kd)
        for dy in range(ks_max):
            for dx in range(ks_max):
                acc = acc + qp[:, dy:dy + ws, dx:dx + ws, :] * dwk[i, dy, dx].float()
        q = (acc * scale).to(dt).reshape(Nw, N, kd)
        s = torch.matmul(q.float(), k.float().transpose(-1, -2)) + bias[i]
        p = torch.softmax(s, dim=-1).to(dt)
        feat = torch.matmul(p.float(), v.float()).to(dt)
        outs.append(feat)
    cat = torch.relu(torch.cat(outs, dim=-1))
    y = torch.matmul(cat.float(), wproj.float()) + bproj.float()
    return y.to(dt).reshape(Nw, ws, ws, C)


def _check(x, biases, idxs, wqkv, bqkv, dwk, dwb, wproj, bproj, ws, heads,
           c_in, kd, d, ks_max):
    if x.ndim != 4 or x.shape[1:3] != (ws, ws):
        raise ValueError(f"x must be (Nw, {ws}, {ws}, C), got {tuple(x.shape)}")
    C, N, L = x.shape[-1], ws * ws, 2 * kd + d
    if c_in != d or C != heads * c_in:
        raise ValueError(f"the cascade needs c_in == d and C == heads*c_in; got "
                         f"c_in={c_in}, d={d}, heads={heads}, C={C}")
    if ks_max % 2 == 0:
        raise ValueError(f"ks_max={ks_max} must be odd")
    if tuple(idxs.shape) != (N, N) or biases.shape[0] != heads:
        raise ValueError(f"idxs {tuple(idxs.shape)} / biases "
                         f"{tuple(biases.shape)} do not fit {heads} heads of {N} tokens")
    want = {"wqkv": (heads, c_in, L), "bqkv": (heads, L),
            "dwk": (heads, ks_max, ks_max, kd), "dwb": (heads, kd),
            "wproj": (heads * d, C), "bproj": (C,)}
    for name, t in zip(want, (wqkv, bqkv, dwk, dwb, wproj, bproj)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} {tuple(t.shape)} != {want[name]}")


class LaunchPlan(NamedTuple):
    """How K4 takes a shape: `windows` windows a block (one for float32) and
    `smem` bytes of shared memory a block."""
    windows: int
    smem: int


def _pad16(n: int) -> int:
    return -(-n // 16) * 16


def _passes(mt: int, nq: int) -> int:
    """Passes of a product over `mt` m-tiles and `nq` 16-column n-pairs: the
    fewest whose share keeps every warp within its tiles."""
    p = 1
    while mt * -(-nq // p) > _WARPS * _UNITS:
        p += 1
    return p


def _bf16_smem(ws: int, heads: int, kd: int, d: int, ks: int, G: int) -> int:
    """Shared memory of a bfloat16 block of G windows (csrc/cga.cu `Dims`):
    over G * pad16(ws²) rows, x, k, q after the conv and v in bf16 at their
    padded strides and q in fp32; two ring slots of 32 weight rows; three
    slots of a head's taps, tap bias and qkv bias; bproj."""
    C, L, R = heads * d, 2 * kd + d, G * _pad16(ws * ws)
    xs, qs, vs = _pad16(C) + 8, _pad16(kd) + 8, _pad16(d) + 8
    bs = max(xs, _pad16(L) + 8)
    return (2 * R * (xs + 2 * qs + vs) + 4 * R * kd + 2 * 2 * _CHUNK * bs
            + 4 * 3 * (ks * ks * kd + kd + L) + 4 * C)


def _fits_pair(ws: int, heads: int, kd: int, d: int, ks: int, G: int) -> bool:
    """Whether a bfloat16 block of G windows lets two blocks share an SM and
    each of its products holds in one pass."""
    mt, L = G * _pad16(ws * ws) // 16, 2 * kd + d
    return (_bf16_smem(ws, heads, kd, d, ks, G) <= SMEM_PAIR
            and _passes(mt, _pad16(heads * d) // 16) == 1 and _passes(mt, _pad16(L) // 16) == 1)


def _wave_fill(windows: int, G: int) -> float:
    """The share of the card's block slots (two an SM) that `windows`
    windows at G a block keep busy over their waves."""
    blocks, slots = -(-windows // G), 2 * SMS
    return blocks / (-(-blocks // slots) * slots)


def _fp32_smem(ws: int, heads: int, kd: int, d: int) -> int:
    """Shared memory of a float32 block (csrc/cga.cu `Layout`)."""
    N, C, S = ws * ws, heads * d, (2 * kd + d) | 1

    def a16(b):
        return -(-b // 16) * 16
    total = a16(N * C * 4) + a16(4 * N * d) + a16(4 * N * S) + a16(4 * N * kd)
    return total + 4 * 8 * MAX_TOKENS


@lru_cache(maxsize=None)
def launch_plan(windows: int, ws: int, heads: int, kd: int, d: int, ks: int,
                dtype: torch.dtype) -> LaunchPlan:
    """K4's plan for `windows` windows of ws x ws, `heads` heads of (kd, d)
    and ks x ks taps; it depends on the shape and dtype only. float32: one
    window a block. bfloat16: among the window counts G (at most
    MAX_WINDOWS) whose block takes at most SMEM_PAIR bytes (two blocks an
    SM) and whose products each hold in one pass, the largest that fills at
    least 90% of its waves' block slots (`_wave_fill`), else the one that
    fills most; one window a block where none of them fits. G moves no sum
    (each window's rows are m-tiles of their own), so no output bit depends
    on it. Raises ValueError where no block fits SMEM_LIMIT (or, for
    bfloat16, kd or d is not a multiple of 8)."""
    if dtype == torch.float32:
        plan = LaunchPlan(1, _fp32_smem(ws, heads, kd, d))
    elif dtype == torch.bfloat16:
        if kd % 8 or d % 8:
            raise ValueError(f"the bfloat16 kernel takes kd and d multiples of 8, got "
                             f"kd={kd}, d={d}")
        best = 0
        for G in range(1, MAX_WINDOWS + 1):
            if not _fits_pair(ws, heads, kd, d, ks, G):
                break
            fill = _wave_fill(windows, G)
            if not best or fill >= 0.9 or fill >= _wave_fill(windows, best):
                best = G
        G = best or 1
        plan = LaunchPlan(G, _bf16_smem(ws, heads, kd, d, ks, G))
    else:
        raise TypeError(f"kernel takes float32 or bfloat16, got {dtype}")
    if plan.smem > SMEM_LIMIT:
        raise ValueError(f"a window of {ws}x{ws} with {heads} heads of d={d} needs "
                         f"{plan.smem} bytes of shared memory > {SMEM_LIMIT}")
    return plan


def library_plan(windows: int, ws: int, heads: int, kd: int, d: int, ks: int,
                 dtype: torch.dtype) -> LaunchPlan:
    """The built kernel's own plan (`cream_cga_plan`; windows 0 where none
    fits), to hold `launch_plan` against on the card."""
    smem = ctypes.c_longlong()
    G = _plan_fn()(windows, ws, heads, kd, d, ks, _DTYPE_CODE[dtype], ctypes.byref(smem))
    return LaunchPlan(G, smem.value)


def fused_cga(x: torch.Tensor, biases: torch.Tensor, idxs, wqkv, bqkv, dwk,
              dwb, wproj, bproj, *, ws: int, heads: int, c_in: int, kd: int,
              d: int, ks_max: int) -> torch.Tensor:
    """The whole CGA of every window, BN pre-folded.

    x (Nw, ws, ws, C); biases (heads, n_off) learned offset table; idxs
    (N, N) bucket ids (`ops.common.attention_bias_indices`; a numpy array
    or an integer tensor); wqkv (heads, c_in, 2kd+d) and wproj
    (heads*d, C) in x's dtype; bqkv, dwk
    (heads, ks_max, ks_max, kd; smaller per-head kernels zero-padded and
    centred), dwb and bproj in fp32 (`fold_cga_variables`). Returns
    (Nw, ws, ws, C) in x's dtype: K4 on CUDA tensors (ws² ≤ 64, float32 or
    bfloat16 with kd and d multiples of 8, on `launch_plan`'s blocks),
    `fused_cga_ref` on CPU tensors."""
    _check(x, biases, idxs, wqkv, bqkv, dwk, dwb, wproj, bproj, ws, heads,
           c_in, kd, d, ks_max)
    kw = dict(ws=ws, heads=heads, c_in=c_in, kd=kd, d=d, ks_max=ks_max)
    if x.device.type == "cpu":
        return fused_cga_ref(x, biases, idxs, wqkv, bqkv, dwk, dwb, wproj,
                             bproj, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"no fused CGA kernel for device {x.device}")
    if ws * ws > MAX_TOKENS:
        raise ValueError(f"window of {ws * ws} tokens > {MAX_TOKENS}")
    if x.dtype not in _DTYPE_CODE or wqkv.dtype != x.dtype or wproj.dtype != x.dtype:
        raise TypeError(f"kernel takes float32 or bfloat16 x with weights of its "
                        f"dtype, got {x.dtype}, {wqkv.dtype}, {wproj.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    others = (biases, wqkv, bqkv, dwk, dwb, wproj, bproj)
    if any(t.device != x.device for t in others):
        raise ValueError("all inputs must be on x's device")
    plan = launch_plan(x.shape[0], ws, heads, kd, d, ks_max, x.dtype)
    return _launch(x, biases, idxs, wqkv, bqkv, dwk, dwb, wproj, bproj, plan.windows,
                   ws=ws, heads=heads, kd=kd, d=d, ks_max=ks_max)


def _launch(x, biases, idxs, wqkv, bqkv, dwk, dwb, wproj, bproj, windows: int, *,
            ws: int, heads: int, kd: int, d: int, ks_max: int) -> torch.Tensor:
    """K4 on `fused_cga`'s checked operands at `windows` windows a block (the
    plan's; the card tests and tools/torch_k4_ab.py also pass others)."""
    bias = _bias_table(biases, idxs).contiguous()
    # the bfloat16 path copies x, the weights and the taps 16 bytes at a time
    f32 = [aligned16(t.float().contiguous()) for t in (bqkv, dwk, dwb, bproj)]
    wqkv, wproj, x = (aligned16(t.contiguous()) for t in (wqkv, wproj, x))
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel()(x.data_ptr(), bias.data_ptr(), wqkv.data_ptr(), f32[0].data_ptr(),
                       f32[1].data_ptr(), f32[2].data_ptr(), wproj.data_ptr(),
                       f32[3].data_ptr(), out.data_ptr(), x.shape[0], ws, heads, kd,
                       d, ks_max, _DTYPE_CODE[x.dtype], kd ** -0.5, windows, stream)
    if rc != 0:
        raise RuntimeError(f"fused CGA kernel launch failed: cudaError {rc}")
    global LAUNCHES
    LAUNCHES += 1
    return out


def _fold(conv_bn) -> tuple[torch.Tensor, torch.Tensor]:
    """A port ConvBN -> (HWIO kernel, bias), BN folded in fp32."""
    bn = conv_bn.bn
    return fold_convbn(conv_bn.c.weight.permute(2, 3, 1, 0), bn.weight, bn.bias,
                       bn.running_mean, bn.running_var)


def fold_cga_variables(module, compute_dtype: torch.dtype):
    """A CascadedGroupAttention's ConvBNs -> `fused_cga`'s operands (wqkv,
    bqkv, dwk, dwb, wproj, bproj): every ConvBN folded in fp32, the per-head
    depthwise kernels zero-padded and centred into ks_max × ks_max, the two
    weight matrices cast to `compute_dtype`. Counterpart of the JAX
    package's `cga.fold_cga_variables`."""
    kd, ks_max = module.kd, module.ks_max
    wqkv, bqkv, dwk, dwb = [], [], [], []
    for qkv, dw in zip(module.qkvs, module.dws):
        kq, bq = _fold(qkv)                               # (1, 1, c_in, 2kd+d)
        wqkv.append(kq[0, 0])
        bqkv.append(bq)
        kdw, bdw = _fold(dw)                              # (ks, ks, 1, kd)
        ks = kdw.shape[0]
        off = (ks_max - ks) // 2
        buf = kdw.new_zeros(ks_max, ks_max, kd)
        buf[off:off + ks, off:off + ks] = kdw[:, :, 0]
        dwk.append(buf)
        dwb.append(bdw)
    kp, bp = _fold(module.proj[1])                        # (1, 1, heads*d, C)
    return (torch.stack(wqkv).to(compute_dtype), torch.stack(bqkv),
            torch.stack(dwk), torch.stack(dwb), kp[0, 0].to(compute_dtype), bp)


@lru_cache(maxsize=None)
def _kernel():
    from cream_tpu_torch.ops import build
    fn = build.load().cream_cga_fused
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_longlong] + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@lru_cache(maxsize=None)
def _plan_fn():
    from cream_tpu_torch.ops import build
    fn = build.load().cream_cga_plan
    fn.argtypes = ([ctypes.c_longlong] + [ctypes.c_int] * 6
                   + [ctypes.POINTER(ctypes.c_longlong)])
    fn.restype = ctypes.c_int
    return fn
