"""The CUDA kernels (K1/K2 window attention forward/backward, K4 fused
cascaded group attention, K5 CGA attention core) against their plain
versions, on the card.

These tests need a CUDA card and skip without one. They import no jax, so
they run on a machine that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(`--noconftest`: the suite's conftest sets up jax.) They cover what
`chip_smoke.py` does not: the other head dims, rectangular maps, the largest
window (256 tokens), small windows, inputs without qkv bias or mask, the
wrappers' refusals, gradients through the K1+K2 autograd.Function, and a
narrow TinyViT whose kernel path and plain path agree, in eval and in a
train step; K4 and K5 at every EfficientViT M0–M5 stage shape at 224 and
at the img-96 windows, their refusals, and a narrow EfficientViT whose
three attention routes agree.
"""
import numpy as np
import pytest
import torch

from cream_tpu_torch.models.efficientvit import (_CONFIGS, CascadedGroupAttention,
                                                EfficientViT)
from cream_tpu_torch.models.tinyvit import TinyViT
from cream_tpu_torch.nn.attention import WindowBiasAttention
from cream_tpu_torch.ops import cga, cga_core
from cream_tpu_torch.ops import window_attention as wa
from cream_tpu_torch.zoo.load import seeded_state_dict

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: python -m pytest --noconftest -m cuda "
                    "tests/test_torch_cuda.py")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _bound(dtype, ref):
    """bf16: two ulps at the largest |out| (P and out each round to bf16 and
    the fp32 sums run in another order); fp32: 1e-5 of the largest |out|."""
    top = max(1.0, ref.abs().max().item())
    if dtype == torch.bfloat16:
        return 2.0 ** (np.floor(np.log2(top)) - 6)
    return 1e-5 * top


def _inputs(rng, B, H, W, ws, heads, kd, dv, use_mask, use_qb, device):
    L, N = heads * (2 * kd + dv), ws * ws
    nwin = (H // ws) * (W // ws)
    qkv = rng.standard_normal((B, H, W, L)).astype(np.float32)
    bias = (rng.standard_normal((heads, N, N)) * 0.5).astype(np.float32)
    mask = np.where(rng.random((nwin, N, N)) < 0.2, -100.0, 0.0).astype(np.float32)
    qb = (rng.standard_normal(L) * 0.1).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(device)
    return t(qkv), t(bias), t(mask) if use_mask else None, t(qb) if use_qb else None


CASES = [
    # B, H, W, ws, heads, kd, dv, layout, mask, qkv_bias
    (2, 14, 14, 7, 6, 32, 32, "head_major", False, True),
    (1, 16, 32, 16, 2, 32, 32, "head_major", False, True),   # 256 tokens, 2 windows
    (2, 14, 21, 7, 3, 16, 64, "head_major", True, True),     # kd != dv, rectangular
    (1, 14, 14, 14, 2, 64, 64, "qkv_major", False, False),   # no qkv bias
    (3, 8, 12, 4, 4, 64, 16, "qkv_major", True, True),       # 16 tokens < one warp
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,ws,heads,kd,dv,layout,use_mask,use_qb", CASES)
def test_kernel_matches_plain(card, dtype, B, H, W, ws, heads, kd, dv, layout,
                              use_mask, use_qb):
    qkv, bias, mask, qb = _inputs(np.random.default_rng(0), B, H, W, ws, heads,
                                  kd, dv, use_mask, use_qb, card)
    qkv = qkv.to(dtype)
    kw = dict(window=ws, heads=heads, kd=kd, dv=dv, layout=layout, qkv_bias=qb)
    before = wa.LAUNCHES
    with torch.inference_mode():
        got = wa.fused_window_attention(qkv, bias, mask, **kw)
        torch.cuda.synchronize()
        want = wa.window_attention_ref(qkv, bias, mask, **kw)
    assert wa.LAUNCHES == before + 1
    assert got.shape == (B, H, W, heads * dv) and got.dtype == dtype
    err = (got.float() - want.float()).abs().max().item()
    assert err <= _bound(dtype, want.float()), err


def test_kernel_refuses_what_it_does_not_take(card):
    qkv, bias, _, _ = _inputs(np.random.default_rng(1), 1, 14, 14, 7, 2, 32, 32,
                              False, False, card)
    kw = dict(window=7, heads=2, kd=32, dv=32)
    with torch.inference_mode():
        with pytest.raises(TypeError):                       # fp16 is not built
            wa.fused_window_attention(qkv.half(), bias, **kw)
        with pytest.raises(ValueError):                      # head dim not built
            wa.fused_window_attention(qkv[..., :2 * 72].contiguous(), bias, window=7,
                                      heads=2, kd=24, dv=24)
        with pytest.raises(ValueError):                      # strided qkv
            wa.fused_window_attention(qkv.transpose(1, 2), bias, **kw)
        with pytest.raises(ValueError):                      # bias on the CPU
            wa.fused_window_attention(qkv, bias.cpu(), **kw)
    dout = torch.zeros(1, 14, 14, 64, device=card)
    with pytest.raises(TypeError):                           # dout of another type
        wa.fused_window_attention_bwd(qkv, bias, None, dout.bfloat16(), **kw)
    with pytest.raises(ValueError):                          # strided dout
        wa.fused_window_attention_bwd(qkv, bias, None, dout.transpose(1, 2), **kw)
    with pytest.raises(ValueError):                          # dout of another shape
        wa.fused_window_attention_bwd(qkv, bias, None, dout[..., :32], **kw)
    with pytest.raises(ValueError):                          # dout on the CPU
        wa.fused_window_attention_bwd(qkv, bias, None, dout.cpu(), **kw)


def _bwd_bound(dtype, ref):
    """dqkv: bf16, two ulps at the largest |dqkv| (both sides round the same
    fp32 sums, taken in other orders, to bf16); fp32, 1e-5 of the largest."""
    top = ref.abs().max().item()
    if dtype == torch.bfloat16:
        return 2.0 ** (np.floor(np.log2(top)) - 6)
    return 1e-5 * top


# + the largest case, whose dK/dV sums do not fit a block's shared memory
BWD_CASES = CASES + [(1, 16, 16, 16, 2, 64, 64, "qkv_major", True, True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,ws,heads,kd,dv,layout,use_mask,use_qb", BWD_CASES)
def test_bwd_kernel_matches_plain(card, dtype, B, H, W, ws, heads, kd, dv,
                                  layout, use_mask, use_qb):
    rng = np.random.default_rng(2)
    qkv, bias, mask, qb = _inputs(rng, B, H, W, ws, heads, kd, dv, use_mask,
                                  use_qb, card)
    qkv = qkv.to(dtype)
    dout = torch.from_numpy(rng.standard_normal((B, H, W, heads * dv)).astype(
        np.float32)).to(card, dtype)
    kw = dict(window=ws, heads=heads, kd=kd, dv=dv, layout=layout, qkv_bias=qb)
    before = wa.BWD_LAUNCHES
    got = wa.fused_window_attention_bwd(qkv, bias, mask, dout, **kw)
    again = wa.fused_window_attention_bwd(qkv, bias, mask, dout, **kw)
    torch.cuda.synchronize()
    want = wa.window_attention_bwd_ref(qkv, bias, mask, dout, **kw)
    assert wa.BWD_LAUNCHES == before + 2
    dqkv, dbias, dqb = got
    assert dqkv.shape == qkv.shape and dqkv.dtype == dtype
    assert dbias.shape == bias.shape and dbias.dtype == torch.float32
    err = (dqkv.float() - want[0].float()).abs().max().item()
    assert err <= _bwd_bound(dtype, want[0].float()), err
    # fp32 sums over every window in another order
    torch.testing.assert_close(dbias, want[1], atol=1e-4 * want[1].abs().max().item(),
                               rtol=0)
    assert torch.equal(dbias, again[1]) and torch.equal(dqkv, again[0])   # deterministic
    if use_qb:
        # the token sum of dqkv, whose elements may differ by an ulp
        lim = (2 ** -6 if dtype == torch.bfloat16 else 1e-4) * want[2].float().abs().max().item()
        torch.testing.assert_close(dqb.float(), want[2].float(), atol=lim, rtol=0)
    else:
        assert dqb is None


@pytest.mark.parametrize("layout,use_mask", [("head_major", False), ("qkv_major", True)])
def test_grads_flow_through_k1_and_k2(card, layout, use_mask):
    """fp32: the autograd.Function's grads are those of autograd through the
    plain forward (P rounding to fp32 is the identity)."""
    rng = np.random.default_rng(3)
    qkv, bias, mask, qb = _inputs(rng, 2, 14, 14, 7, 3, 32, 16, use_mask, True, card)
    kw = dict(window=7, heads=3, kd=32, dv=16, layout=layout)
    leaves = [t.clone().requires_grad_() for t in (qkv, bias, qb)]
    k1, k2 = wa.LAUNCHES, wa.BWD_LAUNCHES
    out = wa.fused_window_attention(leaves[0], leaves[1], mask, qkv_bias=leaves[2], **kw)
    dout = torch.randn_like(out)
    got = torch.autograd.grad(out, leaves, dout)
    assert (wa.LAUNCHES, wa.BWD_LAUNCHES) == (k1 + 1, k2 + 1)
    plain = [t.clone().requires_grad_() for t in (qkv, bias, qb)]
    ref = wa.window_attention_ref(plain[0], plain[1], mask, qkv_bias=plain[2], **kw)
    want = torch.autograd.grad(ref, plain, dout)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        torch.testing.assert_close(g, w, atol=1e-5 * w.abs().max().item(), rtol=0)


NARROW = dict(embed_dims=(32, 32, 64, 64), depths=(1, 2, 1, 1),
              num_heads=(1, 1, 2, 2), window_sizes=(7, 7, 14, 7), num_classes=10)


def _set_kernel(model, on):
    for m in model.modules():
        if isinstance(m, WindowBiasAttention):
            m.use_kernel = on


@pytest.mark.parametrize("img,per_forward", [(112, 4), (100, 2)])  # 100: stage 1 padded
def test_narrow_tinyvit_kernel_path_matches_plain(card, img, per_forward):
    m = TinyViT(img_size=img, device=card, **NARROW).eval()
    m.load_state_dict(seeded_state_dict(m, 5))
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, img, img, 3)).astype(np.float32)).to(card)
    before = wa.LAUNCHES
    with torch.inference_mode():
        got = m(x)
        assert wa.LAUNCHES == before + per_forward
        _set_kernel(m, False)
        want = m(x)
    assert wa.LAUNCHES == before + per_forward
    # fp32 with TF32 off; the kernel sums in another order than the einsums
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("img,per_step", [(112, 4), (100, 2)])    # 100: stage 1 padded
def test_narrow_tinyvit_train_kernel_path_matches_plain(card, img, per_step):
    """fp32, TF32 off: a train-mode forward and backward through K1+K2
    against autograd of the plain attention, same weights and batch."""
    import copy

    from cream_tpu_torch.train.losses import soft_target_ce
    from cream_tpu_torch.train.steps import loss_and_grads

    m = TinyViT(img_size=img, device=card, drop_path_rate=0.0, **NARROW)
    m.load_state_dict(seeded_state_dict(m, 5))
    plain = copy.deepcopy(m)
    _set_kernel(plain, False)
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((4, img, img, 3)).astype(np.float32))
    y = torch.eye(10)[torch.from_numpy(rng.integers(0, 10, 4))]
    batch = {"image": x.to(card), "label": y.to(card)}
    k1, k2 = wa.LAUNCHES, wa.BWD_LAUNCHES
    loss, _, grads = loss_and_grads(m, batch, soft_target_ce)
    assert (wa.LAUNCHES - k1, wa.BWD_LAUNCHES - k2) == (per_step, per_step)
    want_loss, _, want = loss_and_grads(plain, batch, soft_target_ce)
    assert (wa.LAUNCHES - k1, wa.BWD_LAUNCHES - k2) == (per_step, per_step)
    torch.testing.assert_close(loss, want_loss, rtol=1e-5, atol=0)
    # sums in other orders; grads that are zero up to float noise (a bias
    # before a train-mode BN) compare at 1e-7 of the global grad norm
    floor = 1e-7 * torch.sqrt(sum(g.square().sum() for g in want.values())).item()
    for k, w in want.items():
        err = (grads[k] - w).norm().item()
        assert err <= 1e-4 * w.norm().item() + floor, (k, err)
    for k, b in m.named_buffers():          # BN running stats of the same batch
        torch.testing.assert_close(b, dict(plain.named_buffers())[k], rtol=1e-5, atol=1e-6)


def _evit_stages(img=224):
    """(name, ws, C, heads, kernels) of every M0-M5 attention stage at `img`
    (stage resolutions img/16, then halved rounding up; window <= 7)."""
    out = []
    for name, cfg in sorted(_CONFIGS.items()):
        res = img // 16
        for s, (C, h) in enumerate(zip(cfg["embed_dim"], cfg["num_heads"])):
            out.append((f"{name}_s{s}", min(7, res), C, h, cfg["kernels"]))
            res = (res - 1) // 2 + 1
    return out


CGA_STAGES = _evit_stages(224) + [s for s in _evit_stages(96) if s[0].startswith("efficientvit_m0")]


def _cga_bound(dtype, ref, ulps):
    """bf16: `ulps` ulps at the largest |out|; fp32: 1e-5 of the largest."""
    top = max(1.0, ref.abs().max().item())
    if dtype == torch.bfloat16:
        return ulps * 2.0 ** (np.floor(np.log2(top)) - 7)
    return 1e-5 * top


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,d", sorted({(ws * ws, C // h) for _, ws, C, h, _ in CGA_STAGES}))
def test_k5_matches_plain(card, dtype, N, d):
    g = torch.Generator(card).manual_seed(N * d)
    W = 37
    q, k = (torch.randn(W, N, 16, generator=g, device=card).to(dtype) for _ in range(2))
    v = torch.randn(W, N, d, generator=g, device=card).to(dtype)
    bias = torch.randn(N, N, generator=g, device=card) * 0.5
    before = cga_core.LAUNCHES
    with torch.inference_mode():
        got = cga_core.cga_attention(q, k, v, bias, 0.25)
        torch.cuda.synchronize()
        want = cga_core.cga_attention_ref(q, k, v, bias, 0.25)
    assert cga_core.LAUNCHES == before + 1
    assert got.shape == (W, N, d) and got.dtype == dtype
    err = (got.float() - want.float()).abs().max().item()
    # P and out each round to the type; fp32 sums in other orders
    assert err <= _cga_bound(dtype, want.float(), 2), err


def _seeded_cga(C, heads, ws, kernels, device, dtype):
    m = CascadedGroupAttention(C, 16, heads, C / (16 * heads), ws, kernels,
                               device=device, dtype=dtype).eval()
    m.load_state_dict(seeded_state_dict(m, C + ws))
    return m


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,ws,C,heads,kernels", CGA_STAGES)
def test_k4_matches_plain(card, dtype, name, ws, C, heads, kernels):
    m = _seeded_cga(C, heads, ws, kernels, card, dtype)
    g = torch.Generator(card).manual_seed(C)
    x = torch.randn(6, ws, ws, C, generator=g, device=card).to(dtype)
    kw = dict(ws=ws, heads=heads, c_in=C // heads, kd=16, d=C // heads, ks_max=m.ks_max)
    ops = cga.fold_cga_variables(m, dtype)
    before = cga.LAUNCHES
    with torch.inference_mode():
        got = cga.fused_cga(x, m.attention_biases, m.attention_bias_idxs, *ops, **kw)
        torch.cuda.synchronize()
        want = cga.fused_cga_ref(x, m.attention_biases, m.attention_bias_idxs, *ops, **kw)
    assert cga.LAUNCHES == before + 1
    assert got.shape == x.shape and got.dtype == dtype
    err = (got.float() - want.float()).abs().max().item()
    # bf16: an ulp of difference in one head's rounded output feeds the next
    # head and the projection's C-term sums
    assert err <= _cga_bound(dtype, want.float(), 8), err


def test_cga_kernels_refuse_what_they_do_not_take(card):
    q = torch.zeros(4, 81, 16, device=card)
    with pytest.raises(ValueError):                          # 81 tokens > 64
        cga_core.cga_attention(q, q, q, torch.zeros(81, 81, device=card), 0.25)
    q = torch.zeros(4, 49, 16, device=card)
    with pytest.raises(TypeError):                           # fp16 is not built
        cga_core.cga_attention(q.half(), q.half(), q.half(),
                               torch.zeros(49, 49, device=card), 0.25)
    with pytest.raises(ValueError):                          # strided v
        cga_core.cga_attention(q, q, q.transpose(0, 1).contiguous().transpose(0, 1),
                               torch.zeros(49, 49, device=card), 0.25)
    m = _seeded_cga(64, 4, 7, (5, 5, 5, 5), card, torch.float32)
    ops = cga.fold_cga_variables(m, torch.float32)
    kw = dict(ws=7, heads=4, c_in=16, kd=16, d=16, ks_max=5)
    x = torch.zeros(2, 7, 7, 64, device=card)
    with pytest.raises(TypeError):                           # weights of another dtype
        cga.fused_cga(x.bfloat16(), m.attention_biases, m.attention_bias_idxs, *ops, **kw)
    with pytest.raises(ValueError):                          # strided x
        cga.fused_cga(x.transpose(1, 2), m.attention_biases, m.attention_bias_idxs, *ops, **kw)
    with pytest.raises(ValueError):                          # weights on the CPU
        cga.fused_cga(x, m.attention_biases, m.attention_bias_idxs, ops[0].cpu(), *ops[1:], **kw)
    big = _seeded_cga(1024, 2, 7, (3, 3), card, torch.float32)
    xb = torch.zeros(1, 7, 7, 1024, device=card)
    with pytest.raises(ValueError):                          # shared memory > 227 KB
        cga.fused_cga(xb, big.attention_biases, big.attention_bias_idxs, *cga.fold_cga_variables(
            big, torch.float32), ws=7, heads=2, c_in=512, kd=16, d=512, ks_max=3)


EVIT_NARROW = dict(embed_dim=(32, 48, 64), depth=(1, 1, 1), num_heads=(2, 3, 4),
                   kernels=(7, 5, 3, 3), num_classes=10)


@pytest.mark.parametrize("img", [224, 96])
def test_narrow_efficientvit_routes_agree(card, img):
    """fp32, TF32 off: the K4 and K5 routes against the plain route on the
    same weights; one K4 launch per attention block, one K5 per head."""
    m = EfficientViT(img_size=img, device=card, **EVIT_NARROW).eval()
    m.load_state_dict(seeded_state_dict(m, 5))
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, img, img, 3)).astype(np.float32)).to(card)
    out = {}
    for route, k4, k5 in (("cascade", 3, 0), ("core", 0, 9), ("plain", 0, 0)):
        m.set_attn_kernel(route)
        before = (cga.LAUNCHES, cga_core.LAUNCHES)
        with torch.inference_mode():
            out[route] = m(x)
        assert (cga.LAUNCHES - before[0], cga_core.LAUNCHES - before[1]) == (k4, k5), route
    for route in ("cascade", "core"):
        # fp32 sums in other orders; the plain route divides after P.V
        torch.testing.assert_close(out[route], out["plain"], atol=1e-4, rtol=1e-4)
