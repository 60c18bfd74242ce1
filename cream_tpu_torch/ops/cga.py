"""EfficientViT's cascaded group attention as one fused op (eval, BN folded).

`fused_cga` has the contract of the JAX package's
`cream_tpu.ops.pallas.cga.fused_cga`: the whole cascade of every window,
from x to the output projection, with the per-head ConvBNs folded into
weights by `fold_cga_variables`. On CUDA tensors it launches the kernel in
`csrc/cga.cu` (K4); on CPU tensors it runs its plain PyTorch version
`fused_cga_ref`. The TPU kernel padded ws 7 -> 8 with a −1e9 key bucket and
a query mask (a Mosaic layout rule); the CUDA kernel takes the N = ws²
tokens as they are.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch
import torch.nn.functional as F

from cream_tpu_torch.ops.fuse import fold_convbn

MAX_TOKENS = 64                       # tokens per window the kernel takes
SMEM_LIMIT = 232448                   # shared memory one block may use (H100)
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
    bfloat16), `fused_cga_ref` on CPU tensors."""
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
    code = _DTYPE_CODE[x.dtype]
    smem = _smem_bytes()(ws, heads, kd, d, code)
    if smem > SMEM_LIMIT:
        raise ValueError(f"a window of {ws}x{ws} with {heads} heads of d={d} needs "
                         f"{smem} bytes of shared memory > {SMEM_LIMIT}")
    bias = _bias_table(biases, idxs).contiguous()
    f32 = [t.float().contiguous() for t in (bqkv, dwk, dwb, bproj)]
    wqkv, wproj = wqkv.contiguous(), wproj.contiguous()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel()(x.data_ptr(), bias.data_ptr(), wqkv.data_ptr(), f32[0].data_ptr(),
                       f32[1].data_ptr(), f32[2].data_ptr(), wproj.data_ptr(),
                       f32[3].data_ptr(), out.data_ptr(), x.shape[0], ws, heads, kd,
                       d, ks_max, code, kd ** -0.5, stream)
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
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@lru_cache(maxsize=None)
def _smem_bytes():
    from cream_tpu_torch.ops import build
    fn = build.load().cream_cga_smem_bytes
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_longlong
    return fn
