"""cream_tpu_torch's cascaded-group-attention ops vs the JAX package's.

The JAX side runs its Pallas kernels (`cga_core.cga_attention`, `cga.fused_cga`)
in interpret mode on the CPU; the port's side is the plain version each CUDA
kernel is held to on the card (`cga_attention_ref`, `fused_cga_ref`). Weights
are the port's seeded ones, carried to flax's layout; inputs come from numpy
seeds and are fed to both.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cream_tpu.ops import fuse as jax_fuse
from cream_tpu.ops.pallas import cga as jax_cga
from cream_tpu.ops.pallas.cga_core import cga_attention as jax_cga_attention
from cream_tpu.ops.pallas.mbconv import fold_convbn as jax_fold_convbn
from cream_tpu.zoo.import_torch import _TreeBuilder
from cream_tpu_torch.models.efficientvit import CascadedGroupAttention
from cream_tpu_torch.ops import cga, cga_core, fuse
from cream_tpu_torch.zoo.load import seeded_state_dict
from torch_threads import one_torch_thread_module  # noqa: F401


def _np(t):
    return t.detach().float().numpy()


def _bf16_ulp_bound(ref, ulps):
    """`ulps` bf16 ulps at the largest |ref|."""
    top = max(1.0, float(np.abs(ref).max()))
    return ulps * 2.0 ** (np.floor(np.log2(top)) - 7)


# every (N, d) of EfficientViT M0-M5 (N 49 at the 7x7 windows, 16 at stage
# 2's 4x4; d = C / heads in 16..112); W = 16 at N = 49, the JAX kernel's
# smallest block of whole windows (G = 16)
CORE_CASES = [(32, 49, 16, 16), (64, 16, 16, 64), (16, 49, 16, 32)] + [
    (16 if N == 49 else 8, N, 16, d) for N in (16, 49) for d in range(16, 113, 16)
    if (N, d) not in ((49, 16), (16, 64), (49, 32))]


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("W,N,kd,d", CORE_CASES)
def test_core_ref_matches_jax_kernel(W, N, kd, d, dtype):
    rng = np.random.default_rng(W + N + d)
    q, k = (rng.standard_normal((W, N, kd)).astype(np.float32) for _ in range(2))
    v = rng.standard_normal((W, N, d)).astype(np.float32)
    bias = rng.standard_normal((N, N)).astype(np.float32)
    scale = kd ** -0.5
    want = np.asarray(jax_cga_attention(*(jnp.asarray(a, dtype) for a in (q, k, v)),
                                        jnp.asarray(bias), scale, interpret=True), np.float32)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    got = cga_core.cga_attention_ref(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                                     torch.from_numpy(bias), scale)
    assert got.dtype == tdt and got.shape == (W, N, d)
    if dtype == jnp.float32:
        # fp32 on both sides, sums in other orders: the Pallas tests' tolerance
        np.testing.assert_allclose(_np(got), want, atol=2e-5, rtol=2e-5)
    else:
        # the same rounding points (P and out to bf16); one ulp either side
        # where the fp32 sums round the other way
        np.testing.assert_allclose(_np(got), want, atol=_bf16_ulp_bound(want, 1), rtol=0)


def _cga_module(C, heads, ws, kernels, seed, dtype=torch.float32):
    m = CascadedGroupAttention(C, 16, heads, C / (16 * heads), ws, kernels,
                               device="cpu", dtype=dtype).eval()
    m.load_state_dict(seeded_state_dict(m, seed))
    return m


def cga_variables(m: CascadedGroupAttention) -> dict:
    """The port module's weights as the JAX module's variables."""
    sd = {k: v.numpy() for k, v in m.state_dict().items()}
    b = _TreeBuilder()
    for i in range(m.heads):
        b.conv_bn(sd, f"qkvs.{i}", f"qkv_{i}")
        b.conv_bn(sd, f"dws.{i}", f"dw_{i}")
    b.conv_bn(sd, "proj.1", "proj")
    b.raw(sd["attention_biases"], "attention_biases")
    return b.variables()


CGA_CASES = [(7, 64, 4, (5, 3, 5, 3)),      # ws 7, mixed per-head kernel sizes
             (4, 192, 4, (5, 5, 5, 5))]     # ws 4 (JAX pads it to 8), d = 48


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ws,C,heads,kernels", CGA_CASES)
def test_fused_ref_and_fold_match_jax_kernel(ws, C, heads, kernels, dtype):
    m = _cga_module(C, heads, ws, kernels, seed=C)
    d, ks_max = C // heads, max(kernels[:heads])
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    v = cga_variables(m)
    want_ops = jax_cga.fold_cga_variables(v, heads, 16, d, ks_max, jdt)
    ops = cga.fold_cga_variables(m, dtype)
    for got_op, want_op in zip(ops, want_ops):
        assert got_op.dtype == dtype or got_op.dtype == torch.float32
        # the same fp32 fold; rsqrt may differ in the last bit
        np.testing.assert_allclose(_np(got_op), np.asarray(want_op, np.float32),
                                   atol=1e-6, rtol=1e-5)
    x = np.random.default_rng(1).standard_normal((6, ws, ws, C)).astype(np.float32)
    kw = dict(ws=ws, heads=heads, c_in=d, kd=16, d=d, ks_max=ks_max)
    want = np.asarray(jax_cga.fused_cga(jnp.asarray(x, jdt), v["params"]["attention_biases"],
                                        m.attention_bias_idxs.numpy(), *want_ops,
                                        interpret=True, **kw), np.float32)
    got = cga.fused_cga_ref(torch.from_numpy(x).to(dtype), m.attention_biases,
                            m.attention_bias_idxs, *ops, **kw)
    assert got.dtype == dtype and got.shape == x.shape
    if dtype == torch.float32:
        # fp32 through the cascade with sums in other orders (the JAX test's
        # tolerance for this kernel against its module)
        np.testing.assert_allclose(_np(got), want, atol=1e-4, rtol=1e-4)
    else:
        # the same rounding points; an ulp of difference in one head's
        # rounded output feeds the next head and the projection's sums
        # (measured: 1 ulp at |out| ~ 1, in 0.1% of the outputs)
        np.testing.assert_allclose(_np(got), want, atol=_bf16_ulp_bound(want, 2), rtol=0)


def test_fold_follows_load_state_dict():
    """The cascade route caches its fold; a load_state_dict after a forward
    changes the next output to that of a fresh module with the new weights."""
    m = _cga_module(64, 4, 7, (5, 3, 5, 3), seed=1)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (3, 7, 7, 64)).astype(np.float32))
    with torch.inference_mode():
        first = m(x)
        assert torch.equal(m(x), first)             # the cached fold
    sd = seeded_state_dict(m, 2)
    m.load_state_dict(sd)
    fresh = _cga_module(64, 4, 7, (5, 3, 5, 3), seed=2)
    with torch.inference_mode():
        second = m(x)
        assert not torch.allclose(second, first)
        assert torch.equal(second, fresh(x))
    with torch.no_grad():                           # an in-place update of one BN stat
        m.qkvs[0].bn.running_var.mul_(2.0)
    with torch.inference_mode():
        third = m(x)
    assert not torch.allclose(third, second)


def test_routes_agree_on_cpu():
    """fp32: the cascade (K4's plain version), the core (K5's plain version)
    and the plain route (the ones-column softmax, division after P.V)."""
    m = _cga_module(192, 3, 7, (7, 5, 3, 3), seed=3)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (4, 7, 7, 192)).astype(np.float32))
    out = {}
    for route in ("cascade", "core", "plain"):
        m.attn_kernel = route
        with torch.inference_mode():
            out[route] = m(x)
    for route in ("cascade", "core"):
        # fp32 sums in other orders and the division after P.V
        torch.testing.assert_close(out[route], out["plain"], atol=1e-5, rtol=1e-5)


def test_wrappers_take_plain_versions_on_cpu():
    m = _cga_module(64, 4, 7, (5, 5, 5, 5), seed=4)
    ops = (m.attention_biases, m.attention_bias_idxs, *cga.fold_cga_variables(m, torch.float32))
    kw = dict(ws=7, heads=4, c_in=16, kd=16, d=16, ks_max=5)
    x = torch.randn(2, 7, 7, 64)
    k4, k5 = cga.LAUNCHES, cga_core.LAUNCHES
    assert torch.equal(cga.fused_cga(x, *ops, **kw), cga.fused_cga_ref(x, *ops, **kw))
    q, v, bias = torch.randn(3, 49, 16), torch.randn(3, 49, 32), torch.randn(49, 49)
    assert torch.equal(cga_core.cga_attention(q, q, v, bias, 0.25),
                       cga_core.cga_attention_ref(q, q, v, bias, 0.25))
    assert (cga.LAUNCHES, cga_core.LAUNCHES) == (k4, k5)


def test_wrappers_reject_shapes():
    m = _cga_module(64, 4, 7, (5, 5, 5, 5), seed=4)
    bias = (m.attention_biases, m.attention_bias_idxs)
    ops = cga.fold_cga_variables(m, torch.float32)
    kw = dict(ws=7, heads=4, c_in=16, kd=16, d=16, ks_max=5)
    x = torch.zeros(2, 7, 7, 64)
    with pytest.raises(ValueError):                 # x is not (Nw, ws, ws, C)
        cga.fused_cga(x[:, :, :6], *bias, *ops, **kw)
    with pytest.raises(ValueError):                 # c_in != d
        cga.fused_cga(x, *bias, *ops, **{**kw, "d": 8})
    with pytest.raises(ValueError):                 # even ks_max
        cga.fused_cga(x, *bias, *ops, **{**kw, "ks_max": 4})
    with pytest.raises(ValueError):                 # dwk of another kernel size
        cga.fused_cga(x, *bias, *ops[:2], torch.zeros(4, 3, 3, 16), *ops[3:], **kw)
    with pytest.raises(ValueError):                 # bias of another window
        cga_core.cga_attention(torch.zeros(2, 49, 16), torch.zeros(2, 49, 16),
                               torch.zeros(2, 49, 32), torch.zeros(16, 16), 0.25)
    with pytest.raises(ValueError):                 # v with other windows
        cga_core.cga_attention(torch.zeros(2, 49, 16), torch.zeros(2, 49, 16),
                               torch.zeros(3, 49, 32), torch.zeros(49, 49), 0.25)


def test_fuse_matches_jax():
    rng = np.random.default_rng(5)
    kernel = rng.standard_normal((3, 3, 8, 16)).astype(np.float32)
    gamma, beta, mean = (rng.standard_normal(16).astype(np.float32) for _ in range(3))
    var = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    t = torch.from_numpy
    # the same fp32 arithmetic up to sqrt/rsqrt's last bit
    for got, want in ((fuse.fold_conv_bn(t(kernel), t(gamma), t(beta), t(mean), t(var)),
                       jax_fuse.fold_conv_bn(kernel, gamma, beta, mean, var)),
                      (fuse.fold_convbn(t(kernel), t(gamma), t(beta), t(mean), t(var)),
                       jax_fold_convbn(kernel, gamma, beta, mean, var))):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=1e-6)
    lin = rng.standard_normal((16, 10)).astype(np.float32)
    bias = rng.standard_normal(10).astype(np.float32)
    for b in (bias, None):
        got = fuse.fold_bn_linear(t(lin), None if b is None else t(b), t(gamma), t(beta),
                                  t(mean), t(var))
        want = jax_fuse.fold_bn_linear(lin, b, gamma, beta, mean, var)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)
    # the folded linear computes Linear(BN1d(x))
    x = rng.standard_normal((4, 16)).astype(np.float32)
    k2, b2 = fuse.fold_bn_linear(t(lin), t(bias), t(gamma), t(beta), t(mean), t(var))
    bn = (x - mean) / np.sqrt(var + 1e-5) * gamma + beta
    np.testing.assert_allclose(x @ k2.numpy() + b2.numpy(), bn @ lin + bias, atol=1e-4, rtol=1e-4)


def _stage_shapes():
    """(name, ws, C, heads, ks_max) of every M0-M5 attention stage at 224 and
    at 96 (stage resolutions img/16, then halved rounding up; window <= 7)."""
    from cream_tpu_torch.models.efficientvit import _CONFIGS
    out = []
    for img in (224, 96):
        for name, cfg in sorted(_CONFIGS.items()):
            res = img // 16
            for s, (C, h) in enumerate(zip(cfg["embed_dim"], cfg["num_heads"])):
                out.append((f"{name}_{img}_s{s}", min(7, res), C, h, max(cfg["kernels"][:h])))
                res = (res - 1) // 2 + 1
    return out


# the bfloat16 plans (windows a block) of M5 bs512's and M0 bs1024's stages,
# as PERF.md reports them: (model, stage) -> (windows, G)
MAIN_PLANS = {("efficientvit_m5", 0): (2048, 1), ("efficientvit_m5", 1): (512, 1),
              ("efficientvit_m5", 2): (512, 2), ("efficientvit_m0", 0): (4096, 4),
              ("efficientvit_m0", 1): (1024, 2), ("efficientvit_m0", 2): (1024, 4)}
WINDOW_COUNTS = (1, 3, 512, 1000, 4096)


@pytest.mark.parametrize("name,ws,C,heads,ks", _stage_shapes())
def test_launch_plan_fits_every_stage(name, ws, C, heads, ks):
    d = C // heads
    for nw in WINDOW_COUNTS:
        for dtype in (torch.bfloat16, torch.float32):
            plan = cga.launch_plan(nw, ws, heads, 16, d, ks, dtype)
            assert plan.smem <= cga.SMEM_LIMIT
            assert 1 <= plan.windows <= (cga.MAX_WINDOWS if dtype == torch.bfloat16 else 1)
        plan = cga.launch_plan(nw, ws, heads, 16, d, ks, torch.bfloat16)
        # two blocks share an SM wherever more than one window fits
        assert plan.smem == cga._bf16_smem(ws, heads, 16, d, ks, plan.windows)
        assert plan.windows == 1 or plan.smem <= cga.SMEM_PAIR
    model, img, stage = name.rsplit("_", 2)
    if img == "224" and (model, int(stage[1:])) in MAIN_PLANS:
        nw, G = MAIN_PLANS[model, int(stage[1:])]
        assert cga.launch_plan(nw, ws, heads, 16, d, ks, torch.bfloat16).windows == G


@pytest.mark.parametrize("ws", range(1, 9))
def test_launch_plan_fits_every_window_up_to_8(ws):
    """bf16, kd 16: every head count and head dim (a multiple of 8) with
    heads * d <= 384 and kernels of 3, 5 and 7 take a block of at most 227 KB;
    more windows only where the block takes at most half an SM and the
    products of one block take one pass; the plan's G fills at least 90% of
    its waves' block slots where any G that fits does, else fills most."""
    for heads in range(1, 9):
        for d in range(8, 384 // heads + 1, 8):
            for ks in (3, 5, 7):
                # the window counts of a block that shares its SM with another
                fits = [G for G in range(1, cga.MAX_WINDOWS + 1)
                        if cga._fits_pair(ws, heads, 16, d, ks, G)]
                assert fits == list(range(1, len(fits) + 1))
                for nw in WINDOW_COUNTS:
                    plan = cga.launch_plan(nw, ws, heads, 16, d, ks, torch.bfloat16)
                    assert 1 <= plan.windows <= cga.MAX_WINDOWS
                    assert plan.smem <= cga.SMEM_LIMIT
                    if not fits:
                        assert plan.windows == 1
                        continue
                    fill = {G: cga._wave_fill(nw, G) for G in fits}
                    good = [G for G in fits if fill[G] >= 0.9]
                    assert plan.windows in fits
                    if good:
                        assert plan.windows >= max(good)
                    assert fill[plan.windows] >= min(0.9, max(fill.values()))


def test_launch_plan_depends_on_shape_and_dtype_only():
    """The plan takes the window count, the window's shape and the dtype,
    nothing of the data or the device; the same arguments give the same
    plan. bf16 and fp32 plans of one shape differ: the dtype enters."""
    import inspect
    assert list(inspect.signature(cga.launch_plan).parameters) == [
        "windows", "ws", "heads", "kd", "d", "ks", "dtype"]
    fresh = cga.launch_plan.__wrapped__
    for _, ws, C, heads, ks in _stage_shapes():
        for nw in WINDOW_COUNTS:
            for dtype in (torch.bfloat16, torch.float32):
                assert fresh(nw, ws, heads, 16, C // heads, ks, dtype) == cga.launch_plan(
                    nw, ws, heads, 16, C // heads, ks, dtype)
    assert (cga.launch_plan(1024, 4, 4, 16, 48, 5, torch.bfloat16).windows
            != cga.launch_plan(1024, 4, 4, 16, 48, 5, torch.float32).windows)


@pytest.mark.parametrize("ws,heads,kd,d,ks,dtype,error", [
    (7, 2, 16, 512, 3, torch.float32, ValueError),     # fp32 block > 227 KB
    (8, 1, 16, 1024, 7, torch.bfloat16, ValueError),   # no bf16 block fits
    (7, 4, 12, 16, 5, torch.bfloat16, ValueError),     # kd not a multiple of 8
    (7, 4, 16, 20, 5, torch.bfloat16, ValueError),     # d not a multiple of 8
    (1, 8, 16, 256, 3, torch.bfloat16, ValueError),    # C = 2048: the ring alone > 227 KB
    (7, 4, 16, 16, 5, torch.float16, TypeError),       # fp16 is not built
])
def test_launch_plan_refuses_what_no_block_fits(ws, heads, kd, d, ks, dtype, error):
    """The wrapper takes its plan from `launch_plan` before it launches: a
    shape that no block fits raises there, never falls back."""
    with pytest.raises(error):
        cga.launch_plan(64, ws, heads, kd, d, ks, dtype)
