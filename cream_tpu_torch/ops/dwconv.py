"""Depthwise 3x3 convolution (pad 1, stride 1 or 2) with hand-written
forward and backward kernels.

Counterpart of the JAX package's `cream_tpu/ops/dwconv.py`. Public functions
take its layout: x is NHWC (B, H, W, C) and the weight is carried as
w9 = (9, C), tap `3*kh + kw` (the port's (C, 1, 3, 3) conv weight as
`weight.reshape(C, 9).t()`). Three differentiable routes, the counterparts of
the JAX package's three custom_vjps:

  `dw_conv3x3_fused`   stride 1: forward and backward are K7
                       (`csrc/dwconv.cu`, tile kernels; dx and dw in one
                       pass)
  `dw_conv3x3_wg`      stride 1: the library forward (`F.conv2d`,
                       groups=C), the library dx (a depthwise conv of dy with
                       the flipped taps) and K8 for dw
  `dw_conv3x3s2_fused` stride 2: forward and backward are K9 (its
                       backward a tile kernel, dx and dw in one pass)

Like JAX, each returns the weight grad in the dtype of the w9 it received,
so in bf16 the fp32 sum is rounded to bf16 before autograd casts it to the
fp32 param. On CUDA tensors the wrappers launch their kernels or raise; on
CPU tensors they run the plain versions `dw_conv3x3_ref`,
`dw_conv3x3_bwd_ref` and `dw_wgrad_ref`. The TPU kernels' VMEM budget in
`supports_fused` is a Mosaic constraint and is not ported.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Iterator, NamedTuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from cream_tpu_torch.ops.common import aligned16

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since import (or since a caller reset them): K7 forward
# and backward, K8, K9 forward and backward
LAUNCHES = {"k7_fwd": 0, "k7_bwd": 0, "k8": 0, "k9_fwd": 0, "k9_bwd": 0}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


# the tile kernels' plans: threads a block, channel lanes a tile, tile rows
# and columns at most (stride 1; stride 2 in output pixels), staging bytes a
# block at most (both buffers) and blocks aimed for
_THREADS, _MAX_LANES, _MAX_TH, _MAX_TW = 256, 16, 16, 16
_MAX_LANES_S2, _MAX_TH_S2, _MAX_TW_S2 = 32, 8, 8
_STAGES, _MAX_STAGE_BYTES = 2, 96 * 1024       # _STAGES: the kernels' kStages
_TARGET_BLOCKS = 1024


class TilePlan(NamedTuple):
    """How a tile kernel cuts a (B, H, W, C) map: tiles of `th` rows, `tw`
    columns (of the output map: at stride 2 a quarter of x's pixels) and
    `cb` channels, `vec` channels a thread (cb / vec channel lanes), `ni`
    tiles a block at once; a block takes one channel slice and one of
    `groups` contiguous ranges of pixel tiles (the backward: one (9, C) fp32
    dw partial a group)."""
    vec: int
    cb: int
    tw: int
    th: int
    ni: int
    groups: int


def _split(n: int, most: int) -> int:
    """The tile length that cuts n into the fewest tiles of at most `most`,
    as even as they go."""
    parts = -(-n // most)
    return -(-n // parts)


@lru_cache(maxsize=None)
def tile_plan(x_shape, dtype: torch.dtype, backward: bool) -> TilePlan:
    """K7/K8's tile plan for a stride-1 map; it depends only on the shape
    and dtype, so the order of every sum does too. A thread takes 4
    channels forward (2 backward, whose 9 dw sums and 9 taps per channel
    must stay in registers) where C allows, else 2, else 1; a tile up to 16
    channel lanes by 16 columns by 16 rows; a block as many tiles as fit
    256 threads (several whole images at small maps) while the launch keeps
    about 1,024 blocks; the blocks walk their tiles with the next ones'
    copy in flight (two buffers)."""
    B, H, W, C = x_shape
    e = torch.finfo(dtype).bits // 8
    vec = next(v for v in ((2, 1) if backward else (4, 2, 1)) if C % v == 0)
    lanes = max(d for d in range(1, min(C // vec, _MAX_LANES) + 1) if C // vec % d == 0)
    cb = lanes * vec
    tw = _split(W, min(_MAX_TW, _THREADS // lanes))
    th = _split(H, _MAX_TH)
    stage = _STAGES * (th + 2) * (tw + 2) * cb * e * (2 if backward else 1)
    return TilePlan(vec, cb, tw, th, *_blocks(B * -(-H // th) * -(-W // tw), C // cb,
                                               tw * lanes, stage))


def _blocks(pix_tiles: int, slices: int, threads: int, stage: int) -> tuple[int, int]:
    """(NI, groups) of a tile plan whose tile takes `threads` threads and
    `stage` bytes of staging (both buffers): as many tiles a block as fit
    256 threads and 96 KB while the launch keeps about 1,024 blocks."""
    ni = max(1, min(_THREADS // threads, pix_tiles * slices // _TARGET_BLOCKS))
    ni = max(1, min(ni, _MAX_STAGE_BYTES // stage))
    return ni, min(-(-pix_tiles // ni), max(1, -(-_TARGET_BLOCKS // slices)))


def tile_spans(x_shape, plan: TilePlan) -> Iterator[tuple]:
    """The tiles as the kernels walk them: ((group, channel slice), b,
    rows, columns, channels), each of the last three a `range`. Pixel tile
    pt is (image, column tile, row tile) with the row tile fastest; block
    (g, cs) takes pixel tiles [P*g/G, P*(g+1)/G) of slice cs."""
    B, H, W, C = x_shape
    nh, nw, ncs = -(-H // plan.th), -(-W // plan.tw), C // plan.cb
    P = B * nh * nw
    for g in range(plan.groups):
        for cs in range(ncs):
            for pt in range(P * g // plan.groups, P * (g + 1) // plan.groups):
                q, hb = divmod(pt, nh)
                b, wb = divmod(q, nw)
                h0, w0, c0 = hb * plan.th, wb * plan.tw, cs * plan.cb
                yield ((g, cs), b, range(h0, min(h0 + plan.th, H)),
                       range(w0, min(w0 + plan.tw, W)), range(c0, c0 + plan.cb))


def s2_staged_bytes(plan: TilePlan, dtype: torch.dtype) -> int:
    """Shared memory of K9's backward block: two buffers of NI tiles' x
    window ((2TH+1) x (2TW+1)) and dy window ((TH+1) x (TW+1)), CB channels."""
    e = torch.finfo(dtype).bits // 8
    pixels = (2 * plan.th + 1) * (2 * plan.tw + 1) + (plan.th + 1) * (plan.tw + 1)
    return _STAGES * plan.ni * pixels * plan.cb * e


@lru_cache(maxsize=None)
def tile_plan_s2(x_shape, dtype: torch.dtype) -> TilePlan:
    """K9's backward plan for a stride-2 x map, in output pixels; it depends
    only on the shape and dtype, so the order of every sum does too. A
    thread takes 2 channels where C allows (its 9 dw sums and 9 taps per
    channel stay in registers), else 1; a tile up to 32 channel lanes (at
    the model sites a warp is one output column: its shared reads are 128
    contiguous bytes and its branches at the map's edges agree) by 8
    columns by 8 rows, fewer rows where both buffers would pass 96 KB; tiles
    a block and groups as `tile_plan`'s."""
    B, H, W, C = x_shape
    Ho, Wo = _out_size(H, 2), _out_size(W, 2)
    vec = 2 if C % 2 == 0 else 1
    lanes = max(d for d in range(1, min(C // vec, _MAX_LANES_S2) + 1) if C // vec % d == 0)
    cb = lanes * vec
    tw = _split(Wo, min(_MAX_TW_S2, _THREADS // lanes))
    most = max([1] + [h for h in range(1, _MAX_TH_S2 + 1) if s2_staged_bytes(
        TilePlan(vec, cb, tw, h, 1, 1), dtype) <= _MAX_STAGE_BYTES])
    th = _split(Ho, most)
    stage = s2_staged_bytes(TilePlan(vec, cb, tw, th, 1, 1), dtype)
    return TilePlan(vec, cb, tw, th, *_blocks(B * -(-Ho // th) * -(-Wo // tw), C // cb,
                                               tw * lanes, stage))


def tile_spans_s2(x_shape, plan: TilePlan) -> Iterator[tuple]:
    """K9's backward tiles as its kernel walks them (the order of
    `tile_spans`, on the output map): ((group, channel slice), b, output
    rows, output columns, dx rows, dx columns, channels), each of the last
    five a `range`; a tile's outputs write dx rows 2*o0 .. 2*o1 - 1 and
    columns likewise, cut at H and W."""
    B, H, W, C = x_shape
    Ho, Wo = _out_size(H, 2), _out_size(W, 2)
    for gc, b, rows, cols, chans in tile_spans((B, Ho, Wo, C), plan):
        yield (gc, b, rows, cols, range(2 * rows.start, min(2 * rows.stop, H)),
               range(2 * cols.start, min(2 * cols.stop, W)), chans)


def supports_fused(x_shape) -> bool:
    """The stride-1 kernels' shape rule (JAX `supports_fused`): W >= 2."""
    B, H, W, C = x_shape
    return W >= 2 and H >= 1


def supports_fused_s2(x_shape) -> bool:
    """The stride-2 kernels' shape rule (JAX `supports_fused_s2`): even H
    and W, W >= 4."""
    B, H, W, C = x_shape
    return H % 2 == 0 and W % 2 == 0 and W >= 4


def _out_size(n: int, stride: int) -> int:
    return (n - 1) // stride + 1


def _taps(x: torch.Tensor, stride: int):
    """The nine (kh, kw) taps of the zero-padded x read at each output
    pixel, in tap order, as (B, Ho, Wo, C) views."""
    _, H, W, _ = x.shape
    Ho, Wo = _out_size(H, stride), _out_size(W, stride)
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    for kh in range(3):
        for kw in range(3):
            yield xp[:, kh:kh + stride * (Ho - 1) + 1:stride,
                     kw:kw + stride * (Wo - 1) + 1:stride]


def dw_conv3x3_ref(x: torch.Tensor, w9: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Plain version of the forward (JAX `_fwd_kernel`, `_fwd2_kernel`):
    the nine taps multiplied and added in fp32 in tap order (kh outer, kw
    inner), rounded once to x's dtype."""
    w = w9.to(x.dtype).float()
    acc = None
    for t, xs in enumerate(_taps(x, stride)):
        term = xs.float() * w[t]
        acc = term if acc is None else acc + term
    return acc.to(x.dtype)


def dw_wgrad_ref(x: torch.Tensor, dy: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Plain version of the weight grad (JAX `_wgrad_kernel`): (9, C) fp32,
    dw[t] = sum over (b, ho, wo) of x's tap t times dy, in fp32."""
    dyf = dy.float()
    return torch.stack([(xs.float() * dyf).sum(dim=(0, 1, 2)) for xs in _taps(x, stride)])


def dw_conv3x3_bwd_ref(x: torch.Tensor, dy: torch.Tensor, w9: torch.Tensor,
                       stride: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the backward (JAX `_bwd_kernel`, `_bwd2_kernel`):
    dx[h, w] sums w[t] * dy over the taps t whose read reaches (h, w), in fp32
    in tap order, rounded once to dy's dtype; dw as `dw_wgrad_ref`."""
    B, H, W, C = x.shape
    Ho, Wo = dy.shape[1:3]
    w = w9.to(x.dtype).float()
    dyf = dy.float()
    dxp = torch.zeros(B, H + 2, W + 2, C, dtype=torch.float32, device=x.device)
    for t in range(9):
        kh, kw = divmod(t, 3)
        dxp[:, kh:kh + stride * (Ho - 1) + 1:stride,
            kw:kw + stride * (Wo - 1) + 1:stride] += dyf * w[t]
    return dxp[:, 1:H + 1, 1:W + 1].to(dy.dtype), dw_wgrad_ref(x, dy, stride)


def _check(x: torch.Tensor, dy: torch.Tensor | None, w9: torch.Tensor | None,
           stride: int) -> None:
    if x.ndim != 4:
        raise ValueError(f"x must be NHWC (B, H, W, C), got {tuple(x.shape)}")
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    B, H, W, C = x.shape
    if w9 is not None and tuple(w9.shape) != (9, C):
        raise ValueError(f"w9 {tuple(w9.shape)} != {(9, C)}")
    want = (B, _out_size(H, stride), _out_size(W, stride), C)
    if dy is not None and tuple(dy.shape) != want:
        raise ValueError(f"dy {tuple(dy.shape)} != {want}")


def _check_cuda(*ts: torch.Tensor) -> None:
    x = ts[0]
    if x.device.type != "cuda":
        raise ValueError(f"no depthwise-conv kernel for device {x.device}")
    if x.dtype not in _DTYPE_CODE or any(t.dtype != x.dtype for t in ts):
        raise TypeError(f"kernels take float32 or bfloat16 tensors of one dtype, got "
                        f"{[t.dtype for t in ts]}")
    if any(t.device != x.device for t in ts):
        raise ValueError("all inputs must be on x's device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("inputs must be contiguous")
    if x.numel() >= 2 ** 31:
        raise ValueError(f"x has {x.numel()} elements, the kernels take < 2**31")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def dw_conv3x3_fwd(x: torch.Tensor, w9: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Depthwise 3x3 pad-1 conv, NHWC x (B, H, W, C) and w9 (9, C) ->
    (B, Ho, Wo, C) in x's dtype: K7 (stride 1) or K9 (stride 2) on CUDA
    tensors, `dw_conv3x3_ref` on CPU tensors."""
    _check(x, None, w9, stride)
    if x.device.type == "cpu":
        return dw_conv3x3_ref(x, w9, stride)
    w9 = w9.to(x.dtype).contiguous()
    _check_cuda(x, w9)
    x, w9 = aligned16(x), aligned16(w9)
    B, H, W, C = x.shape
    y = torch.empty(B, _out_size(H, stride), _out_size(W, stride), C,
                    dtype=x.dtype, device=x.device)
    args = (x.data_ptr(), w9.data_ptr(), y.data_ptr(), B, H, W, C, _DTYPE_CODE[x.dtype])
    with torch.cuda.device(x.device):
        if stride == 1:
            plan = tile_plan(x.shape, x.dtype, backward=False)
            rc = _lib().cream_dwconv_tile_fwd(*args, *plan, _stream(x))
        else:
            rc = _lib().cream_dwconv_s2_fwd(*args, _stream(x))
    if rc != 0:
        raise RuntimeError(f"depthwise-conv forward launch failed: cudaError {rc}")
    LAUNCHES["k7_fwd" if stride == 1 else "k9_fwd"] += 1
    return y


def _bwd_launch(x, dy, w9, stride, with_dx, plan: TilePlan | None = None):
    """K7/K8 (stride 1) or K9's backward (stride 2) on `plan`, by default
    `tile_plan` / `tile_plan_s2`'s; a plan the C entry refuses raises."""
    B, H, W, C = x.shape
    if plan is None:
        plan = (tile_plan(x.shape, x.dtype, backward=True) if stride == 1
                else tile_plan_s2(x.shape, x.dtype))
    partial = torch.empty(plan.groups, 9, C, dtype=torch.float32, device=x.device)
    dw9 = torch.empty(9, C, dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x) if with_dx else None
    lib = _lib()
    entry = lib.cream_dwconv_tile_bwd if stride == 1 else lib.cream_dwconv_s2_tile_bwd
    with torch.cuda.device(x.device):
        rc = entry(x.data_ptr(), dy.data_ptr(), w9.data_ptr() if with_dx else None,
                   dx.data_ptr() if with_dx else None, partial.data_ptr(), dw9.data_ptr(),
                   B, H, W, C, _DTYPE_CODE[x.dtype], *plan, _stream(x))
    if rc != 0:
        raise RuntimeError(f"depthwise-conv backward launch failed: cudaError {rc}")
    return dx, dw9


def dw_conv3x3_bwd(x: torch.Tensor, dy: torch.Tensor, w9: torch.Tensor,
                   stride: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """(dx in dy's dtype, dw (9, C) fp32) of `dw_conv3x3_fwd`: K7 (stride 1)
    or K9 (stride 2) on CUDA tensors, `dw_conv3x3_bwd_ref` on CPU tensors.
    dw is summed in a fixed order: the same bits on every launch."""
    _check(x, dy, w9, stride)
    if x.device.type == "cpu":
        return dw_conv3x3_bwd_ref(x, dy, w9, stride)
    w9 = w9.to(x.dtype).contiguous()
    _check_cuda(x, dy, w9)
    out = _bwd_launch(aligned16(x), aligned16(dy), aligned16(w9), stride, with_dx=True)
    LAUNCHES["k7_bwd" if stride == 1 else "k9_bwd"] += 1
    return out


def dw_wgrad(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """The stride-1 weight grad alone, (9, C) fp32: K8 on CUDA tensors,
    `dw_wgrad_ref` on CPU tensors."""
    _check(x, dy, None, 1)
    if x.device.type == "cpu":
        return dw_wgrad_ref(x, dy)
    _check_cuda(x, dy)
    _, dw9 = _bwd_launch(aligned16(x), aligned16(dy), None, 1, with_dx=False)
    LAUNCHES["k8"] += 1
    return dw9


def _conv_weight(w9: torch.Tensor) -> torch.Tensor:
    """(9, C) taps -> the (C, 1, 3, 3) weight of a depthwise `F.conv2d`."""
    return w9.t().reshape(-1, 1, 3, 3)


def _library_conv(x: torch.Tensor, w9: torch.Tensor) -> torch.Tensor:
    """Depthwise 3x3 s1 p1 conv of NHWC x as one library call (its NCHW view
    has channels_last strides); NHWC out."""
    y = F.conv2d(x.permute(0, 3, 1, 2), _conv_weight(w9.to(x.dtype)), None, 1, 1, 1,
                 x.shape[-1])
    return y.permute(0, 2, 3, 1)


class _Fused(torch.autograd.Function):
    """K7 (stride 1) or K9 (stride 2) forward and backward."""

    @staticmethod
    def forward(ctx, x, w9, stride):
        ctx.save_for_backward(x, w9)
        ctx.stride = stride
        return dw_conv3x3_fwd(x, w9, stride)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, w9 = ctx.saved_tensors
        dx, dw9 = dw_conv3x3_bwd(x, dy.contiguous(), w9, ctx.stride)
        return dx, dw9.to(w9.dtype), None


class _Wgrad(torch.autograd.Function):
    """Library forward and dx, K8 weight grad (stride 1)."""

    @staticmethod
    def forward(ctx, x, w9):
        ctx.save_for_backward(x, w9)
        return _library_conv(x, w9)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, w9 = ctx.saved_tensors
        dy = dy.contiguous()
        dx = _library_conv(dy, w9.flip(0))            # the flipped taps
        return dx, dw_wgrad(x, dy).to(w9.dtype)


def dw_conv3x3_fused(x: torch.Tensor, w9: torch.Tensor) -> torch.Tensor:
    """Depthwise 3x3 s1 p1 conv, NHWC, K7 forward and backward (JAX
    `dw_conv3x3_fused`). x must pass `supports_fused`."""
    if not supports_fused(x.shape):
        raise ValueError(f"dw_conv3x3_fused does not take {tuple(x.shape)} (W < 2)")
    return _Fused.apply(x, w9, 1)


def dw_conv3x3_wg(x: torch.Tensor, w9: torch.Tensor) -> torch.Tensor:
    """Depthwise 3x3 s1 p1 conv, NHWC: library forward and dx, K8 weight
    grad (JAX `dw_conv3x3_wg`). x must pass `supports_fused`."""
    if not supports_fused(x.shape):
        raise ValueError(f"dw_conv3x3_wg does not take {tuple(x.shape)} (W < 2)")
    return _Wgrad.apply(x, w9)


def dw_conv3x3s2_fused(x: torch.Tensor, w9: torch.Tensor) -> torch.Tensor:
    """Depthwise 3x3 s2 p1 conv, NHWC, K9 forward and backward (JAX
    `dw_conv3x3s2_fused`). x must pass `supports_fused_s2`."""
    if not supports_fused_s2(x.shape):
        raise ValueError(f"dw_conv3x3s2_fused does not take {tuple(x.shape)} "
                         f"(needs even H and W, W >= 4)")
    return _Fused.apply(x, w9, 2)


@lru_cache(maxsize=None)
def _lib():
    from cream_tpu_torch.ops import build
    lib = build.load()
    ptr, i = ctypes.c_void_p, ctypes.c_int
    for name, argtypes in (
            ("cream_dwconv_tile_fwd", [ptr] * 3 + [i] * 11 + [ptr]),
            ("cream_dwconv_tile_bwd", [ptr] * 6 + [i] * 11 + [ptr]),
            ("cream_dwconv_s2_fwd", [ptr] * 3 + [i] * 5 + [ptr]),
            ("cream_dwconv_s2_tile_bwd", [ptr] * 6 + [i] * 11 + [ptr])):
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = i
    return lib
