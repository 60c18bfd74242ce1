"""The eval MBConv with BatchNorm folded, as one op.

`fused_mbconv` has the contract of the JAX package's
`cream_tpu.ops.pallas.mbconv.fused_mbconv`: x (B, H, W, C) through 1x1
expand -> GELU -> 3x3 depthwise -> GELU -> 1x1 project -> + x -> GELU, with
the hidden (B, H, W, HID) tensor never stored. On CUDA tensors it launches
the kernel in `csrc/mbconv.cu` (K6) on the grid of tiles `tile_plan` gives
(`tile_spans` lists the pixels each block writes); on CPU tensors it runs its plain PyTorch version
`fused_mbconv_ref`. `fold_mbconv` is the counterpart of
`fold_mbconv_variables`: it folds an `nn.layers.MBConv`'s three ConvBNs into
the seven operands. The TPU kernel's gate (a VMEM budget and `hid % 128`) is
a Mosaic rule and is not ported; `supports_shape` is the CUDA kernel's own.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Iterator, NamedTuple

import torch
import torch.nn.functional as F

from cream_tpu_torch.ops.common import aligned16
from cream_tpu_torch.ops.fuse import fold_convbn

CHANNELS = (32, 64, 96, 128)          # C the kernel is built for
HID_CHUNK = 32                        # HID must be a multiple of this
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SQRT_2_OVER_PI = 0.7978845608028654

# kernel launches since import (or since a caller reset them)
LAUNCHES = 0


class TilePlan(NamedTuple):
    """How K6 cuts a (B, H, W, C) map: square output tiles of `tile` pixels
    a side, `tiles_h` x `tiles_w` of them an image, one block each. The
    kernel is launched on this grid ((tiles_h * tiles_w, B) blocks); its C
    entry refuses a grid that does not cover the map in its build's tiles."""
    tile: int
    tiles_h: int
    tiles_w: int


# the tile side each dtype's kernel is built for (`kTile` in csrc/mbconv.cu)
_TILE = {torch.bfloat16: 14, torch.float32: 8}


@lru_cache(maxsize=None)
def tile_plan(x_shape, dtype: torch.dtype) -> TilePlan:
    """K6's tile plan for x of `x_shape` (B, H, W, C) in `dtype`; it depends
    only on the shape and dtype, so the order of every sum does too. The
    tile side is the build's (14 for bfloat16, 8 for float32); maps that
    are not whole tiles end in a ragged tile whose pixels outside the map
    are masked. Blocks are not persistent: one a tile."""
    B, H, W, C = x_shape
    tile = _TILE[dtype]
    return TilePlan(tile, -(-H // tile), -(-W // tile))


def tile_spans(x_shape, plan: TilePlan) -> Iterator[tuple]:
    """The blocks of the plan's grid as the kernel reads its block index:
    ((tile index, image), b, output rows, output columns), the last two
    `range`s clipped to the map; tile index t (blockIdx.x) is row tile
    t // tiles_w, column tile t % tiles_w."""
    B, H, W, C = x_shape
    for b in range(B):
        for t in range(plan.tiles_h * plan.tiles_w):
            y0, x0 = t // plan.tiles_w * plan.tile, t % plan.tiles_w * plan.tile
            yield ((t, b), b, range(y0, min(y0 + plan.tile, H)),
                   range(x0, min(x0 + plan.tile, W)))


def supports_shape(x_shape, hid: int, dtype: torch.dtype) -> bool:
    """Whether K6 takes x of `x_shape` (B, H, W, C) with `hid` hidden
    channels in `dtype`: C in `CHANNELS`, HID a multiple of 32, float32 or
    bfloat16, at most 65535 images."""
    B, H, W, C = x_shape
    return (C in CHANNELS and hid >= HID_CHUNK and hid % HID_CHUNK == 0
            and dtype in _DTYPE_CODE and 1 <= B <= 65535 and H >= 1 and W >= 1)


def fold_mbconv(module: torch.nn.Module, dtype: torch.dtype):
    """An `nn.layers.MBConv`'s conv1/conv2/conv3 ConvBNs, BN folded in
    fp32 -> (w1 (C, HID), b1, dw (3, 3, HID), bdw, w2 (HID, C), b2): w1 and
    w2 cast to `dtype` after folding, dw and the biases fp32."""
    def fold(cb):
        # (O, I, kh, kw) -> HWIO, the layout `fold_convbn` scales on O
        k = cb.c.weight.permute(2, 3, 1, 0)
        return fold_convbn(k, cb.bn.weight, cb.bn.bias, cb.bn.running_mean,
                           cb.bn.running_var, cb.bn.eps)

    k1, b1 = fold(module.conv1)                 # (1, 1, C, HID)
    kd, bd = fold(module.conv2)                 # (3, 3, 1, HID)
    k2, b2 = fold(module.conv3)                 # (1, 1, HID, C)
    w1 = k1.reshape(k1.shape[2], k1.shape[3]).to(dtype)
    dw = kd.reshape(3, 3, kd.shape[3])
    w2 = k2.reshape(k2.shape[2], k2.shape[3]).to(dtype)
    return tuple(t.contiguous() for t in (w1, b1, dw, bd, w2, b2))


def gelu_fp32(x: torch.Tensor, exact: bool) -> torch.Tensor:
    """GELU of fp32 values in the JAX kernel's operation order: the erf form
    if `exact`, else the tanh form."""
    if exact:
        return 0.5 * x * (1.0 + torch.erf(x * 2.0 ** -0.5))
    return 0.5 * x * (1.0 + torch.tanh(_SQRT_2_OVER_PI * (x + 0.044715 * x * x * x)))


def fused_mbconv_ref(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                     dw: torch.Tensor, bdw: torch.Tensor, w2: torch.Tensor,
                     b2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of `fused_mbconv`, with the numerics of the
    JAX package's `mbconv._kernel`: h = x·w1 summed in fp32, + b1, GELU in
    fp32, rounded to x's dtype; the zero-padded h's nine taps multiplied and
    added in fp32 onto bdw in (dy, dx) order, GELU, rounded; h2·w2 in fp32,
    + b2, + x, GELU, rounded. GELU is erf for float32 x, tanh otherwise."""
    B, H, W, C = x.shape
    exact = x.dtype == torch.float32
    hid = w1.shape[1]
    h = torch.matmul(x.reshape(-1, C).float(), w1.float())
    h = gelu_fp32(h + b1.float(), exact).to(x.dtype).reshape(B, H, W, hid)
    hp = F.pad(h, (0, 0, 1, 1, 1, 1))
    acc = bdw.float().expand(B, H, W, hid).clone()
    for dy in range(3):
        for dx in range(3):
            acc += hp[:, dy:dy + H, dx:dx + W].float() * dw[dy, dx].float()
    h2 = gelu_fp32(acc, exact).to(x.dtype)
    y = torch.matmul(h2.reshape(-1, hid).float(), w2.float())
    y = y + b2.float() + x.reshape(-1, C).float()
    return gelu_fp32(y, exact).reshape(B, H, W, C).to(x.dtype)


def fused_mbconv(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                 dw: torch.Tensor, bdw: torch.Tensor, w2: torch.Tensor,
                 b2: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, C); w1 (C, HID) and w2 (HID, C) (cast to x's dtype); dw
    (3, 3, HID), bdw (HID,), b1 (HID,), b2 (C,) fp32, BN folded by the
    caller (`fold_mbconv`). Returns (B, H, W, C) in x's dtype: K6 on CUDA
    tensors (`supports_shape`, contiguous x), `fused_mbconv_ref` on CPU
    tensors."""
    B, H, W, C = x.shape
    hid = w1.shape[1]
    shapes = {"w1": (w1, (C, hid)), "b1": (b1, (hid,)), "dw": (dw, (3, 3, hid)),
              "bdw": (bdw, (hid,)), "w2": (w2, (hid, C)), "b2": (b2, (C,))}
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"{name} {tuple(t.shape)} != {want} for x {tuple(x.shape)}")
    if x.device.type == "cpu":
        return fused_mbconv_ref(x, w1, b1, dw, bdw, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"no MBConv kernel for device {x.device}")
    if not supports_shape(x.shape, hid, x.dtype):
        raise ValueError(f"the MBConv kernel does not take x {tuple(x.shape)} {x.dtype} "
                         f"with HID {hid} (C in {CHANNELS}, HID % {HID_CHUNK} == 0)")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if any(t.device != x.device for t, _ in shapes.values()):
        raise ValueError("all inputs must be on x's device")
    # the bf16 kernel copies every operand 16 bytes at a time
    w1, w2 = (aligned16(t.to(x.dtype).contiguous()) for t in (w1, w2))
    b1, dw, bdw, b2 = (aligned16(t.to(torch.float32).contiguous()) for t in (b1, dw, bdw, b2))
    x = aligned16(x)
    plan = tile_plan(tuple(x.shape), x.dtype)
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel()(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), dw.data_ptr(),
                       bdw.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
                       B, H, W, C, hid, _DTYPE_CODE[x.dtype], plan.tiles_h, plan.tiles_w,
                       stream)
    if rc != 0:
        raise RuntimeError(f"MBConv kernel launch failed: cudaError {rc}")
    global LAUNCHES
    LAUNCHES += 1
    return out


@lru_cache(maxsize=None)
def _kernel():
    from cream_tpu_torch.ops import build
    fn = build.load().cream_mbconv_fwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
