"""cream_tpu_torch's depthwise 3x3 convolution ops vs the JAX package's.

The JAX side runs its Pallas kernels (`dw_conv3x3_fused`, `dw_conv3x3_wg`,
`dw_conv3x3s2_fused`) in interpret mode on the CPU, through `jax.vjp` for
the backward; the port's side is the plain version each CUDA kernel (K7, K8,
K9) is held to on the card. Inputs come from numpy seeds and are fed to both.
Also: each autograd.Function's CPU route against autograd of
`F.conv2d(groups=C)`, ConvBN's routing, the depthwise sites of an
EfficientViT-M5 step at 224, and the tile plans of the K7/K8 and K9
backward kernels (every output once; K9's parity-phase dx, emulated tile by
tile, bit-identical to the plain version).
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from cream_tpu.ops import dwconv as jax_dw
from cream_tpu_torch.models import create_model
from cream_tpu_torch.models.efficientvit import PatchMerging
from cream_tpu_torch.nn.layers import DW_KERNELS, ConvBN, set_dw_kernel
from cream_tpu_torch.ops import dwconv
from torch_threads import one_torch_thread_module  # noqa: F401

# (B, H, W, C, stride): a TinyViT-like map, the CGA's 7x7 q-depthwise at 16
# channels, a stride-2 PatchMerging map, a TinyViT local_conv-like map at
# narrow width, a ragged map, a stride-2 map whose output is not square
CASES = [(2, 8, 8, 32, 1), (2, 7, 7, 16, 1), (2, 8, 8, 32, 2), (2, 14, 14, 48, 1),
         (2, 9, 13, 24, 1), (2, 10, 6, 24, 2)]


def _np(t):
    return t.detach().float().numpy()


def _inputs(B, H, W, C, stride, seed=0):
    rng = np.random.default_rng(seed + H + C + stride)
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 1, C)) / 3).astype(np.float32)     # HWIO
    dy = rng.standard_normal((B, Ho, Wo, C)).astype(np.float32)
    return x, w, dy


def _w9(w):
    """JAX's HWIO (3, 3, 1, C) kernel as the port's (9, C) taps."""
    return torch.from_numpy(np.ascontiguousarray(w.reshape(9, -1)))


def _jax_fn(stride):
    return jax_dw.dw_conv3x3_fused if stride == 1 else jax_dw.dw_conv3x3s2_fused


def _port_fn(stride):
    return dwconv.dw_conv3x3_fused if stride == 1 else dwconv.dw_conv3x3s2_fused


def _close(got, want, dtype, rel):
    """fp32: `rel` of the largest |want|; bf16: one ulp at the largest |want|
    (the same rounding points, fp32 sums that may round the other way)."""
    top = float(np.abs(want).max())
    if dtype == torch.bfloat16:
        np.testing.assert_allclose(got, want, atol=2.0 ** (np.floor(np.log2(top)) - 7), rtol=0)
    else:
        np.testing.assert_allclose(got, want, atol=rel * top, rtol=0)


PARAMS = [(*c, torch.float32) for c in CASES] + [
    (*c, torch.bfloat16) for c in CASES if c[-1] == 1 and c != (2, 7, 7, 16, 1)]


@pytest.mark.parametrize("B,H,W,C,stride,dtype", PARAMS)
def test_forward_ref_matches_pallas(B, H, W, C, stride, dtype):
    x, w, _ = _inputs(B, H, W, C, stride)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = np.asarray(_jax_fn(stride)(jnp.asarray(x, jdt), jnp.asarray(w, jdt), True),
                      np.float32)
    got = dwconv.dw_conv3x3_fwd(torch.from_numpy(x).to(dtype), _w9(w).to(dtype), stride)
    assert got.dtype == dtype and tuple(got.shape) == want.shape
    _close(_np(got), want, dtype, 1e-6)


@pytest.mark.parametrize("B,H,W,C,stride,dtype", PARAMS)
def test_backward_ref_and_function_match_pallas_vjp(B, H, W, C, stride, dtype):
    x, w, dy = _inputs(B, H, W, C, stride)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jx, jw, jdy = (jnp.asarray(a, jdt) for a in (x, w, dy))
    _, vjp = jax.vjp(lambda a, b: _jax_fn(stride)(a, b, True), jx, jw)
    want_dx, want_dw = (np.asarray(t, np.float32) for t in vjp(jdy))
    tx, tdy = torch.from_numpy(x).to(dtype), torch.from_numpy(dy).to(dtype)
    w9 = _w9(w).to(dtype)
    # the plain version: dx in dy's dtype, dw in fp32
    dx, dw9 = dwconv.dw_conv3x3_bwd_ref(tx, tdy, w9, stride)
    assert dx.dtype == dtype and dw9.dtype == torch.float32
    _close(_np(dx), want_dx, dtype, 1e-6)
    if dtype == torch.float32:
        _close(_np(dw9), want_dw.reshape(9, C), dtype, 1e-5)
    # the autograd.Function's CPU route: dw rounded to w9's dtype, as JAX's
    leaves = [tx.clone().requires_grad_(), w9.clone().requires_grad_()]
    out = _port_fn(stride)(*leaves)
    gx, gw = torch.autograd.grad(out, leaves, tdy)
    assert gw.dtype == dtype
    _close(_np(gx), want_dx, dtype, 1e-6)
    # dw sums over B*Ho*Wo terms in another order
    _close(_np(gw), want_dw.reshape(9, C), dtype, 1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wgrad_ref_and_function_match_pallas_vjp(dtype):
    B, H, W, C = 2, 8, 8, 32
    x, w, dy = _inputs(B, H, W, C, 1, seed=5)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jx, jw, jdy = (jnp.asarray(a, jdt) for a in (x, w, dy))
    want_y, vjp = jax.vjp(lambda a, b: jax_dw.dw_conv3x3_wg(a, b, True), jx, jw)
    want_dx, want_dw = (np.asarray(t, np.float32) for t in vjp(jdy))
    want_dw9 = np.asarray(jax_dw._pallas_wgrad(jx, jdy, True))      # the kernel's fp32 sum
    tx, tdy = torch.from_numpy(x).to(dtype), torch.from_numpy(dy).to(dtype)
    _close(_np(dwconv.dw_wgrad_ref(tx, tdy)), want_dw9, torch.float32, 1e-5)
    leaves = [tx.clone().requires_grad_(), _w9(w).to(dtype).requires_grad_()]
    out = dwconv.dw_conv3x3_wg(*leaves)
    gx, gw = torch.autograd.grad(out, leaves, tdy)
    # forward and dx are library convolutions on both sides (XLA / PyTorch)
    _close(_np(out), np.asarray(want_y, np.float32), dtype, 1e-6)
    _close(_np(gx), want_dx, dtype, 1e-6)
    _close(_np(gw), want_dw.reshape(9, C), dtype, 1e-5)


def test_odd_stride2_map_takes_the_library_conv():
    """A 7x7 map at stride 2 (EfficientViT's second PatchMerging) fails
    `supports_fused_s2`: ConvBN keeps the library conv on every route, as
    JAX's `dw_conv3x3s2_auto` does, and the result matches JAX's conv."""
    B, H, W, C = 2, 7, 7, 16
    assert not dwconv.supports_fused_s2((B, H, W, C))
    x, w, _ = _inputs(B, H, W, C, 2)
    m = ConvBN(C, C, 3, 2, 1, groups=C, device="cpu", dw_kernel="fused").eval()
    with torch.no_grad():
        m.c.weight.copy_(torch.from_numpy(w).permute(3, 2, 0, 1))
    assert m.is_dw3x3() and m._dw_route(torch.from_numpy(x)) is None
    with pytest.raises(ValueError, match="even"):
        dwconv.dw_conv3x3s2_fused(torch.from_numpy(x), _w9(w))
    conv = np.asarray(jax_dw.dw_conv3x3s2_fused(jnp.asarray(x), jnp.asarray(w), True))
    bn = m.bn
    scale = (bn.weight / torch.sqrt(bn.running_var + bn.eps)).detach().numpy()
    want = (conv - bn.running_mean.numpy()) * scale + bn.bias.detach().numpy()
    with torch.no_grad():
        got = m(torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("fn,stride", [(dwconv.dw_conv3x3_fused, 1), (dwconv.dw_conv3x3_wg, 1),
                                       (dwconv.dw_conv3x3s2_fused, 2)])
def test_functions_match_autograd_of_conv2d(fn, stride):
    B, H, W, C = 2, 6, 10, 8
    x, w, dy = _inputs(B, H, W, C, stride, seed=9)
    tx, w9, tdy = torch.from_numpy(x), _w9(w), torch.from_numpy(dy)
    leaves = [tx.clone().requires_grad_(), w9.clone().requires_grad_()]
    out = fn(*leaves)
    got = torch.autograd.grad(out, leaves, tdy)
    ref_leaves = [tx.clone().requires_grad_(), w9.clone().requires_grad_()]
    ref = F.conv2d(ref_leaves[0].permute(0, 3, 1, 2), ref_leaves[1].t().reshape(C, 1, 3, 3),
                   None, stride, 1, 1, C).permute(0, 2, 3, 1)
    want = torch.autograd.grad(ref, ref_leaves, tdy)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, atol=1e-5, rtol=1e-5)


def test_wrappers_refuse_what_they_do_not_take():
    x = torch.zeros(1, 4, 4, 8)
    with pytest.raises(ValueError):
        dwconv.dw_conv3x3_fwd(x, torch.zeros(9, 4))            # taps of another C
    with pytest.raises(ValueError):
        dwconv.dw_conv3x3_fwd(x, torch.zeros(9, 8), stride=3)
    with pytest.raises(ValueError):
        dwconv.dw_conv3x3_bwd(x, torch.zeros(1, 4, 4, 8), torch.zeros(9, 8), stride=2)
    with pytest.raises(ValueError):
        dwconv.dw_conv3x3_fused(torch.zeros(1, 4, 1, 8), torch.zeros(9, 8))   # W < 2
    with pytest.raises(ValueError):
        dwconv.dw_conv3x3_fwd(x.to("meta"), torch.zeros(9, 8, device="meta"))


def test_convbn_routes_and_set_dw_kernel():
    x = torch.zeros(2, 8, 8, 16)
    dw1 = ConvBN(16, 16, 3, 1, 1, groups=16, device="cpu")
    dw2 = ConvBN(16, 16, 3, 2, 1, groups=16, device="cpu")
    dense = ConvBN(16, 16, 3, 1, 1, device="cpu")
    dw5 = ConvBN(16, 16, 5, 1, 2, groups=16, device="cpu")
    want = {"library": (None, None), "fused": (dwconv.dw_conv3x3_fused, dwconv.dw_conv3x3s2_fused),
            "wgrad": (dwconv.dw_conv3x3_wg, None)}
    for mode in DW_KERNELS:
        for m in (dw1, dw2, dense, dw5):
            m.dw_kernel = mode
        assert (dw1._dw_route(x), dw2._dw_route(x)) == want[mode], mode
        assert dense._dw_route(x) is None and dw5._dw_route(x) is None
    # W < 2: the library conv
    assert dw1._dw_route(torch.zeros(2, 8, 1, 16)) is None
    tiny = create_model("tiny_vit_5m_224", device="cpu")
    convbns = [m for m in tiny.modules() if isinstance(m, ConvBN)]
    assert {m.dw_kernel for m in convbns} == {"library"}         # TinyViT's default
    set_dw_kernel(tiny, "fused")
    assert {m.dw_kernel for m in convbns} == {"fused"}
    with pytest.raises(ValueError):
        set_dw_kernel(tiny, "other")
    with pytest.raises(ValueError):
        ConvBN(16, 16, 3, 1, 1, groups=16, device="cpu", dw_kernel="other")
    with pytest.raises(ValueError):
        create_model("efficientvit_m0", device="cpu", dw_kernel="other")


def test_efficientvit_m5_depthwise_sites_at_224():
    """The depthwise 3x3 sites of one EfficientViT-M5 step at 224, read from
    the modules: 32 at stride 1 (16 block dw0/dw1, 4 subsample pre/post, 12
    CGA q-depthwise of kernel 3) and 2 at stride 2, of which the 14x14 map's
    takes K9 and the 7x7 map's the library conv."""
    m = create_model("efficientvit_m5", device="cpu")
    s1 = [n for n, c in m.named_modules() if isinstance(c, ConvBN) and c.is_dw3x3()
          and c.stride == 1]
    s2 = [n for n, c in m.named_modules() if isinstance(c, ConvBN) and c.is_dw3x3()
          and c.stride == 2]
    kinds = {"block": sum(n.endswith((".dw0.m", ".dw1.m")) for n in s1),
             "subsample": sum(n.endswith((".0.0.m", ".2.0.m")) for n in s1),
             "cga": sum(".dws." in n for n in s1)}
    assert len(s1) == 32 and kinds == {"block": 16, "subsample": 4, "cga": 12}
    merges = [c for c in m.modules() if isinstance(c, PatchMerging)]
    assert s2 == ["blocks2.1.conv2", "blocks3.1.conv2"] and len(merges) == 2
    maps = [224 // 16, (224 // 16 - 1) // 2 + 1]                 # 14, 7
    hid = [c.conv2.c.out_channels for c in merges]
    assert [dwconv.supports_fused_s2((512, s, s, h)) for s, h in zip(maps, hid)] == [True, False]
    # the 5x5 and 7x7 q-depthwise convs stay on the library conv
    other = [c for n, c in m.named_modules() if ".dws." in n and isinstance(c, ConvBN)
             and not c.is_dw3x3()]
    assert sorted({c.c.kernel_size[0] for c in other}) == [5, 7] and len(other) == 16


# stride-1 shapes the tile kernels see: EfficientViT-M5 bs512's and
# TinyViT-21M-224 bs256's sites (chip_smoke.DW_M5, DW_TINYVIT) and the card
# tests' shapes (tests/test_torch_cuda.py DW_CASES)
TILE_SHAPES = [(512, 14, 14, 192), (2048, 7, 7, 16), (512, 7, 7, 288), (512, 7, 7, 16),
               (512, 4, 4, 384), (512, 4, 4, 16), (256, 56, 56, 384), (256, 28, 28, 192),
               (256, 14, 14, 384), (256, 7, 7, 576), (4, 14, 14, 192), (16, 7, 7, 16),
               (4, 7, 7, 288), (4, 4, 4, 384), (8, 4, 4, 16), (2, 56, 56, 384), (3, 9, 6, 15),
               (2, 28, 28, 192), (2, 14, 14, 384), (2, 7, 7, 576), (2, 57, 35, 40),
               (1, 1, 2, 8)]


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tile_plan_covers_every_output_once(dtype, backward):
    """K7/K8's tiles cover every (pixel, channel) of the map exactly once;
    a block takes whole tiles of one channel slice within 256 threads, and
    every group has tiles (the backward sums one dw partial a group)."""
    for B, H, W, C in TILE_SHAPES:
        plan = dwconv.tile_plan((B, H, W, C), dtype, backward)
        lanes = plan.cb // plan.vec
        assert C % plan.cb == 0 and plan.cb % plan.vec == 0 and plan.vec <= (2 if backward else 4)
        assert plan.ni * plan.tw * lanes <= 256 and plan.tw <= 16 and plan.th <= 16
        count = np.zeros((B, H, W, C // plan.cb), np.int32)
        groups = set()
        for (g, cs), b, rows, cols, chans in dwconv.tile_spans((B, H, W, C), plan):
            assert chans == range(cs * plan.cb, (cs + 1) * plan.cb)
            count[b, rows.start:rows.stop, cols.start:cols.stop, cs] += 1
            groups.add(g)
        assert (count == 1).all(), (B, H, W, C, plan)
        assert groups == set(range(plan.groups))


# stride-2 maps K9's backward sees: TinyViT-21M-224 bs256's and
# EfficientViT-M5 bs512's PatchMerging sites (chip_smoke.DW_TINYVIT, DW_M5),
# the card tests' stride-2 shapes (tests/test_torch_cuda.py DW_CASES) and
# odd maps (dx rows or columns past H or W, one output pixel)
S2_SHAPES = [(256, 56, 56, 192), (256, 28, 28, 384), (256, 14, 14, 576), (512, 14, 14, 768),
             (4, 14, 14, 768), (2, 56, 56, 192), (2, 14, 14, 576), (3, 8, 6, 15), (2, 7, 7, 16),
             (2, 28, 28, 384), (2, 9, 13, 24), (1, 2, 4, 8), (2, 57, 35, 40), (1, 1, 1, 8),
             (3, 31, 17, 64)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_s2_tile_plan_covers_every_output_once(dtype):
    """K9's backward tiles cover every dy pixel and every dx pixel (each
    channel slice) exactly once; a block takes whole tiles of one channel
    slice within 256 threads and 96 KB of staged windows (its dw reduction
    too), and every group has tiles."""
    for B, H, W, C in S2_SHAPES:
        Ho, Wo = (H - 1) // 2 + 1, (W - 1) // 2 + 1
        plan = dwconv.tile_plan_s2((B, H, W, C), dtype)
        lanes = plan.cb // plan.vec
        threads = plan.ni * plan.tw * lanes
        assert C % plan.cb == 0 and plan.cb % plan.vec == 0 and plan.vec <= 2
        assert threads <= 256 and plan.tw <= 8 and plan.th <= 8
        assert dwconv.s2_staged_bytes(plan, dtype) <= 96 * 1024
        assert threads * 9 * plan.vec * 4 <= 96 * 1024
        dy_count = np.zeros((B, Ho, Wo, C // plan.cb), np.int32)
        dx_count = np.zeros((B, H, W, C // plan.cb), np.int32)
        groups = set()
        for (g, cs), b, rows, cols, dx_rows, dx_cols, chans in dwconv.tile_spans_s2(
                (B, H, W, C), plan):
            assert chans == range(cs * plan.cb, (cs + 1) * plan.cb)
            assert len(rows) <= plan.th and len(cols) <= plan.tw
            dy_count[b, rows.start:rows.stop, cols.start:cols.stop, cs] += 1
            dx_count[b, dx_rows.start:dx_rows.stop, dx_cols.start:dx_cols.stop, cs] += 1
            groups.add(g)
        assert (dy_count == 1).all() and (dx_count == 1).all(), (B, H, W, C, plan)
        assert groups == set(range(plan.groups))


def _s2_dx_by_tiles(x_shape, dy, w9, plan):
    """K9's backward dx as its kernel computes it, in torch: tile by tile
    (`tile_spans_s2`), from the tile's dy window (its outputs and one pixel
    below and to the right, where the map has them), each output's four dx
    phases summed in fp32 from 0 in tap order, the product and the sum
    rounded apart, only over taps whose dy lies in the map, rounded once."""
    B, H, W, C = x_shape
    Ho, Wo = dy.shape[1:3]
    w = w9.to(dy.dtype).float()
    dx = torch.full((B, H, W, C), float("nan"))
    for _, b, rows, cols, dx_rows, dx_cols, chans in dwconv.tile_spans_s2(x_shape, plan):
        o0, o1, p0, p1 = rows.start, rows.stop, cols.start, cols.stop
        win = dy[b, o0:min(o1 + 1, Ho), p0:min(p1 + 1, Wo), chans.start:chans.stop].float()
        wt = w[:, chans.start:chans.stop]
        n, m = o1 - o0, p1 - p0
        out = torch.zeros(2 * n, 2 * m, len(chans))
        for i in (0, 1):
            for j in (0, 1):
                acc = torch.zeros(n, m, len(chans))
                # dx(2o+i, 2p+j) takes kh = 1 (i = 0) or kh = 0, 2 (i = 1):
                # kh = 0 reads dy row o + 1, kh = 1 and 2 row o; kw likewise
                for t in range(9):
                    kh, kw = divmod(t, 3)
                    if (kh == 1) != (i == 0) or (kw == 1) != (j == 0):
                        continue
                    di, dj = int(kh == 0), int(kw == 0)
                    rn, cn = min(n, win.shape[0] - di), min(m, win.shape[1] - dj)
                    acc[:rn, :cn] = acc[:rn, :cn] + wt[t] * win[di:di + rn, dj:dj + cn]
                out[i::2, j::2] = acc
        dx[b, dx_rows.start:dx_rows.stop, dx_cols.start:dx_cols.stop,
           chans.start:chans.stop] = out[:len(dx_rows), :len(dx_cols)]
    return dx.to(dy.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,C", [(2, 8, 8, 32), (3, 8, 6, 15), (2, 7, 7, 16),
                                     (2, 9, 13, 24), (1, 2, 4, 8), (2, 30, 22, 64)])
def test_s2_parity_phase_dx_is_the_plain_dx_bit_for_bit(B, H, W, C, dtype):
    """The parity-phase dx of K9's backward, emulated tile by tile in its
    tap order, has the plain version's bits on even and odd maps."""
    x, w, dy = _inputs(B, H, W, C, 2, seed=3)
    tdy, w9 = torch.from_numpy(dy).to(dtype), _w9(w).to(dtype)
    want, _ = dwconv.dw_conv3x3_bwd_ref(torch.from_numpy(x).to(dtype), tdy, w9, 2)
    got = _s2_dx_by_tiles((B, H, W, C), tdy, w9, dwconv.tile_plan_s2((B, H, W, C), dtype))
    assert got.dtype == want.dtype and torch.equal(got.view(torch.int16 if dtype == torch.bfloat16
                                                            else torch.int32),
                                                   want.view(torch.int16 if dtype == torch.bfloat16
                                                             else torch.int32))
