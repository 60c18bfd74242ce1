"""cream_tpu_torch's fused eval MBConv (K6's plain version) vs the JAX package's.

The JAX side runs its Pallas kernel `cream_tpu.ops.pallas.mbconv.fused_mbconv`
in interpret mode on the CPU and its unfused `MBConv` module; the port's side
is `fused_mbconv_ref`, the plain version the CUDA kernel is held to on the
card, and the port's `MBConv` / `TinyViT` with the fused route on. Weights
are the port's seeded ones, carried to flax's layout; inputs come from numpy
seeds and are fed to both.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cream_tpu.nn.layers import MBConv as JaxMBConv
from cream_tpu.models.tinyvit import TinyViT as JaxTinyViT
from cream_tpu.ops.pallas import mbconv as jax_mbconv
from cream_tpu.zoo.import_torch import convert_tinyvit
from cream_tpu_torch.cli.inference import predict
from cream_tpu_torch.models.tinyvit import TinyViT
from cream_tpu_torch.nn.layers import MBConv, set_mbconv_kernel
from cream_tpu_torch.ops import mbconv
from cream_tpu_torch.zoo.load import seeded_state_dict
from torch_threads import one_torch_thread_module  # noqa: F401


def _np(t):
    return t.detach().float().numpy()


def _bf16_ulp(top):
    """One bf16 ulp at |top| (at least at 1)."""
    return 2.0 ** (np.floor(np.log2(max(1.0, float(top)))) - 7)


def _seeded(C, seed=0, expand=4.0):
    m = MBConv(C, expand)
    m.load_state_dict(seeded_state_dict(m, seed))
    return m.eval()


def jax_variables(m: MBConv) -> dict:
    """The port MBConv's weights in flax's tree."""
    params, stats = {}, {}
    for name in ("conv1", "conv2", "conv3"):
        cb = getattr(m, name)
        params[name] = {"conv": {"kernel": _np(cb.c.weight).transpose(2, 3, 1, 0)},
                        "bn": {"scale": _np(cb.bn.weight), "bias": _np(cb.bn.bias)}}
        stats[name] = {"bn": {"mean": _np(cb.bn.running_mean), "var": _np(cb.bn.running_var)}}
    return {"params": params, "batch_stats": stats}


def _input(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _jax_kernel(x: np.ndarray, ops, dtype) -> np.ndarray:
    out = jax_mbconv.fused_mbconv(jnp.asarray(x, dtype), *ops, interpret=True)
    return np.asarray(out.astype(jnp.float32))


def _port_ref(x: np.ndarray, ops, dtype) -> np.ndarray:
    t = [torch.from_numpy(np.array(o.astype(jnp.float32))) for o in ops]
    t[0], t[4] = t[0].to(dtype), t[4].to(dtype)           # w1, w2 in the compute dtype
    return _np(mbconv.fused_mbconv_ref(torch.from_numpy(x).to(dtype), *t))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fold_matches_jax(dtype):
    m = _seeded(32, seed=3)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jax_mbconv.fold_mbconv_variables(jax_variables(m), jdtype)
    got = mbconv.fold_mbconv(m, dtype)
    names = ("w1", "b1", "dw", "bdw", "w2", "b2")
    for name, g, w in zip(names, got, want):
        w = np.asarray(w.astype(jnp.float32))
        assert tuple(g.shape) == w.shape, name
        assert g.dtype == (dtype if name in ("w1", "w2") else torch.float32), name
        # fp32 folds round rsqrt and the products alike up to an ulp; a bf16
        # cast of values an fp32 ulp apart may land one bf16 ulp apart
        rtol = 2.0 ** -8 if g.dtype == torch.bfloat16 else 1e-6
        np.testing.assert_allclose(_np(g), w, rtol=rtol, atol=1e-7, err_msg=name)


# (B, H, W, C, HID): the JAX test's 8x8x32 shape, maps that are not whole 8x8
# tiles, and TinyViT-5M/11M's C = 64 at a narrow map; maps that the bf16
# kernel's 14x14 tiles cut raggedly
SHAPES = [(2, 8, 8, 32, 128), (1, 9, 7, 32, 96), (2, 6, 10, 64, 256), (2, 15, 15, 32, 64),
          (1, 57, 35, 64, 256)]


@pytest.mark.parametrize("B,H,W,C,HID", SHAPES)
def test_plain_matches_jax_kernel_fp32(B, H, W, C, HID):
    m = _seeded(C, seed=B + H + W, expand=HID / C)
    ops = jax_mbconv.fold_mbconv_variables(jax_variables(m), jnp.float32)
    x = _input((B, H, W, C), seed=H * W)
    want = _jax_kernel(x, ops, jnp.float32)
    got = _port_ref(x, ops, torch.float32)
    # the JAX package's own kernel-vs-module tolerance (test_pallas_kernels)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("B,H,W,C,HID", SHAPES)
def test_plain_matches_jax_kernel_bf16(B, H, W, C, HID):
    m = _seeded(C, seed=B + H + W, expand=HID / C)
    ops = jax_mbconv.fold_mbconv_variables(jax_variables(m), jnp.bfloat16)
    x = _input((B, H, W, C), seed=H * W)
    want = _jax_kernel(x, ops, jnp.bfloat16)
    got = _port_ref(x, ops, torch.bfloat16)
    # both round h, h2 and y to bf16 at the same points; their fp32 sums
    # run in other orders, so a rounding of h may land one ulp apart and
    # move y by an ulp: 2 bf16 ulps at the largest |y|
    assert np.abs(got - want).max() <= 2 * _bf16_ulp(np.abs(want).max())


def test_hidden_tensor_is_zero_padded():
    """The depthwise taps outside the image read h = 0, not the expansion
    of a zero pixel (GELU(b1) != 0): with a large b1 the two differ at the
    border, and the plain version and the JAX kernel both take the first."""
    m = _seeded(32, seed=9)
    w1, b1, dw, bdw, w2, b2 = mbconv.fold_mbconv(m, torch.float32)
    b1 = torch.full_like(b1, 3.0)
    x = torch.from_numpy(_input((1, 6, 6, 32), seed=4))
    got = mbconv.fused_mbconv_ref(x, w1, b1, dw, bdw, w2, b2)
    ops = [jnp.asarray(_np(t)) for t in (w1, b1, dw, bdw, w2, b2)]
    want = np.asarray(jax_mbconv.fused_mbconv(jnp.asarray(x.numpy()), *ops, interpret=True))
    np.testing.assert_allclose(_np(got), want, atol=2e-5, rtol=1e-4)
    # the other padding: expand a zero-padded x, so the halo holds GELU(b1)
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    h = mbconv.gelu_fp32(xp @ w1 + b1, True)
    acc = bdw.expand(1, 6, 6, -1).clone()
    for dy in range(3):
        for dx in range(3):
            acc += h[:, dy:dy + 6, dx:dx + 6] * dw[dy, dx]
    y = mbconv.gelu_fp32(mbconv.gelu_fp32(acc, True) @ w2 + b2 + x, True)
    border = (y - got).abs()
    assert border[:, 1:-1, 1:-1].max() < 1e-5          # interior pixels agree
    assert border.max() > 1e-2                          # the border does not


@pytest.mark.parametrize("C", [32, 64])
def test_module_route_matches_jax_module(C):
    m = _seeded(C, seed=C)
    m.use_kernel = True
    x = _input((2, 9, 9, C), seed=C + 1)
    with torch.inference_mode():
        assert m.kernel_path(torch.from_numpy(x))
        got = _np(m(torch.from_numpy(x)))
    want = np.asarray(JaxMBConv(C, 4.0).apply(jax_variables(m), jnp.asarray(x)))
    # BN folded into fp32 weights vs BN applied: the JAX kernel test's tolerance
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)
    # the route is a shape rule: other channel counts take the module path
    assert not m.kernel_path(torch.zeros(1, 4, 4, C + 1))


def test_route_follows_mode_and_weights():
    """The route runs only in eval outside autograd, and the folded weights
    follow `load_state_dict`."""
    m = _seeded(32, seed=1)
    set_mbconv_kernel(m, True)
    x = torch.from_numpy(_input((1, 8, 8, 32)))
    assert not m.kernel_path(x)                         # autograd records here
    with torch.no_grad():
        assert m.kernel_path(x)
        a = m(x)
        m.load_state_dict(seeded_state_dict(m, 2))
        b = m(x)
        set_mbconv_kernel(m, False)
        c = m(x)
        m.train()
        assert not (m.use_kernel or m.kernel_path(x))
    assert not torch.equal(a, b)
    torch.testing.assert_close(b, c, atol=2e-5, rtol=1e-4)


def test_supports_shape_and_refusals():
    assert mbconv.supports_shape((256, 56, 56, 96), 384, torch.bfloat16)
    assert mbconv.supports_shape((256, 56, 56, 64), 256, torch.float32)
    assert not mbconv.supports_shape((1, 8, 8, 48), 192, torch.bfloat16)   # C
    assert not mbconv.supports_shape((1, 8, 8, 32), 100, torch.bfloat16)   # HID % 32
    assert not mbconv.supports_shape((1, 8, 8, 32), 128, torch.float16)
    ops = mbconv.fold_mbconv(_seeded(32), torch.float32)
    with pytest.raises(ValueError, match="w1"):
        mbconv.fused_mbconv(torch.zeros(1, 4, 4, 64), *ops)


# (B, H, W, C): TinyViT-5M/11M's (C 64) and -21M's (C 96) stage-0 maps at
# bs256, the card tests' K6 shapes and maps that 14x14 tiles cut raggedly
PLAN_SHAPES = [(256, 56, 56, 64), (256, 56, 56, 96), (2, 56, 56, 96), (2, 56, 56, 64),
               (3, 9, 13, 32), (1, 20, 12, 128), (2, 7, 7, 96), (2, 15, 15, 32),
               (1, 57, 35, 64), (2, 1, 1, 96), (3, 30, 23, 96), (2, 9, 9, 96)]


@pytest.mark.parametrize("shape", PLAN_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tile_plan_covers_every_output_once(dtype, shape):
    """K6's grid of tiles, which the kernel is launched on, covers every
    output pixel of the map exactly once, each in a block of its own; its
    tile side is the one the dtype's kernel is built with (`kTile` in
    csrc/mbconv.cu, float32's then bfloat16's); the plan is a function of
    shape and dtype alone."""
    B, H, W, C = shape
    plan = mbconv.tile_plan(shape, dtype)
    src = (Path(mbconv.__file__).parent.parent / "csrc" / "mbconv.cu").read_text()
    built = dict(zip((torch.float32, torch.bfloat16),
                     map(int, re.findall(r"constexpr int kTile = (\d+);", src))))
    assert plan.tile == built[dtype]
    count = np.zeros((B, H, W), np.int32)
    blocks = set()
    for block, b, rows, cols in mbconv.tile_spans(shape, plan):
        assert len(rows) <= plan.tile and len(cols) <= plan.tile and len(rows) and len(cols)
        count[b, rows.start:rows.stop, cols.start:cols.stop] += 1
        blocks.add(block)
    assert (count == 1).all(), (shape, plan)
    assert len(blocks) == B * plan.tiles_h * plan.tiles_w
    mbconv.tile_plan.cache_clear()
    assert mbconv.tile_plan(shape, dtype) == plan
    assert mbconv.tile_plan((1, H, W, C), dtype)[:1] == plan[:1]


def test_bf16_gelu_tanh_form_error_bound():
    """The bf16 kernel's GELU tanh (`tanh_of` in csrc/mbconv.cu, its
    constants read from the source), emulated in float32 with ex2.approx
    and rcp.approx at the ends of their error bounds (2 and 1 ulps): within
    the 2^-21 the kernel's note states of tanh(u), at the JAX form's u =
    sqrt(2/pi) (x + 0.044715 x^3), for every x."""
    src = (Path(mbconv.__file__).parent.parent / "csrc" / "mbconv.cu").read_text()
    k0, k1 = (np.float32(re.search(rf"constexpr float {n} = ([0-9.]+)f;", src).group(1))
              for n in ("kE2", "kE2c"))
    assert abs(k1 / k0 - 0.044715) < 1e-7 and abs(k0 - 2 * np.log2(np.e) * np.sqrt(2 / np.pi)) < 1e-6
    f32 = np.float32
    x = np.concatenate([np.random.default_rng(0).standard_normal(500_000) * 3,
                        np.linspace(-12, 12, 500_001)]).astype(f32)
    a = (np.abs(x) * (np.float64(k1 * x) * x + k0).astype(f32)).astype(f32)
    s = (x + ((f32(0.044715) * x) * x) * x).astype(f32)
    want = np.tanh((f32(np.sqrt(2 / np.pi)) * s).astype(f32).astype(np.float64))
    worst = 0.0
    for e_err in (-2, 0, 2):
        for r_err in (-1, 0, 1):
            with np.errstate(over="ignore"):
                e = (np.exp2(a.astype(np.float64)) * (1 + e_err * 2.0 ** -23)).astype(f32)
            r = (1 / (f32(1) + e).astype(np.float64) * (1 + r_err * 2.0 ** -23)).astype(f32)
            t = np.copysign((-2 * r.astype(np.float64) + 1).astype(f32), x)
            worst = max(worst, np.abs(t - want).max())
    assert worst < 2.0 ** -21, worst


NARROW = dict(embed_dims=(32, 32, 64, 64), depths=(2, 1, 1, 1),
              num_heads=(1, 1, 2, 2), window_sizes=(7, 7, 14, 7), num_classes=10)


def test_narrow_tinyvit_with_mbconv_kernel_matches_jax():
    m = TinyViT(img_size=112, device="cpu", mbconv_kernel=True, **NARROW).eval()
    sd = seeded_state_dict(m, 5)
    m.load_state_dict(sd)
    x = _input((2, 112, 112, 3), seed=7)
    variables = convert_tinyvit({k: v.numpy() for k, v in sd.items()},
                                depths=NARROW["depths"])
    want = np.asarray(jax.jit(JaxTinyViT(**NARROW).apply)(variables, jnp.asarray(x)))
    got = predict(m, torch.from_numpy(x)).numpy()
    assert all(b.use_kernel for b in m.layers[0].blocks)
    # fp32 through ~20 layers, the two MBConvs with BN folded
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
