"""The CUDA kernels (K1/K2 window attention forward/backward, K3 bias
attention, K4 fused cascaded group attention, K5 CGA attention core, K6 fused
eval MBConv, K7/K8/K9 depthwise 3x3 convolution, K10 window relayout, K11
layout pin) against their plain versions, on the card.

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
three attention routes agree; K4's bf16 blocks of several windows with the
last one short, the same bits at every block size and on two launches,
taps wider than the window, padded head dims and its launch plan against
the library's; K7/K8/K9 at EfficientViT-M5's and
TinyViT-21M's depthwise shapes (smaller batches), odd channel counts and odd
stride-2 maps, dw's bits across launches, their refusals (a tile plan the
C entry refuses raises), their autograd.Functions' grads, and a narrow EfficientViT train step whose three
depthwise routes agree and launch the kernels the site count says; K6 at
TinyViT's stage-0 shapes (smaller batches), ragged tiles and every built
channel count, its zero-padded hidden tensor and the MBConv route; K3 at
TinyViT's and EfficientViT's window sizes up to 256 tokens, kd != dv and
head dims that are not multiples of 16 or 8, the BiasAttention route; K3
and K5 on offset views and the same bf16 bits on two launches; K10 bit for
bit at 16-, 8-, 4- and 2-byte accesses and inside forward_windowed; K11 bit for bit with its identity backward; a
narrow TinyViT whose pin_layouts and mbconv_kernel routes agree with the
plain one; Swin's attention at S3-Tiny's and Swin-B's four stage shapes
(qkv_major, the shift mask, grads into the bias table and the qkv bias
through K2), with S3-Tiny, Swin-T, Mini-Swin-T and Swin-B launching 12, 12,
0 and 24 K1 a forward and S3-Tiny's train step 12 K1 + 12 K2; the
sparse logits store's native codec (it needs only g++, so it also runs
without a card); and TinyCLIP's serving path, which runs no kernel: the
narrow ViT and RN CLIPs (gated and ragged too) in fp32 on the card against
the CPU, bf16 against fp32, and the pair timing; TinyCLIP's training path,
which runs none either: the narrow L0 distillation step in fp32 on the card
against the CPU (the same uniforms), its prune on the card, and the train
timing with and without remat; DeiT with iRPE and Mini-DeiT, which run none
either: `IRPE` at DeiT-S's shape and narrow models in fp32 on the card
against the CPU (the gather's scatter-add sums with atomics on the card),
and Mini-Swin's distillation capture; the DARTS / CDARTS / NAS-Bench-201
networks, which reach K7/K9 at their SepConv sites on "fused": the kernels
at those sites, a SepConv on "fused" against "library", a search network's
weight and alpha steps launching at the sites' rule, and narrow networks on
the card against the CPU; the detectors over EfficientViT-M4: K4 at their
attention windows (padded 7x7 windows over a 32x32 stage-0 map, 4x4 over
8x8 at canvas 512; 4x4 and 2x2 at 128), RetinaNet's and Mask R-CNN's bf16
outputs on "cascade" within 8 ulps of "plain" with 6 K4 launches a
forward, and a train step on "fused" launching K7/K9 at every site the
port's enumeration counts, none refused; the data-parallel global
BatchNorm's passes on the card (ATen's fused SyncBN kernels) against their
written-out versions on the CPU; the gated train-mode BN (`ops.bn`) on the
card against the CPU.
"""
import numpy as np
import pytest
import torch

from cream_tpu_torch.models.efficientvit import (_CONFIGS, CascadedGroupAttention,
                                                EfficientViT)
from cream_tpu_torch.models.tinyvit import TinyViT
from cream_tpu_torch.nn.attention import WindowBiasAttention
from cream_tpu_torch.models.cream import dw3x3_path_sites, dw3x3_sites
from cream_tpu_torch.nn.layers import ConvBN
from cream_tpu_torch.ops import cga, cga_core, dwconv
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
    (1, 24, 24, 12, 3, 32, 32, "head_major", False, True),   # 144 tokens (TinyViT-384)
    (1, 12, 24, 12, 2, 16, 64, "qkv_major", True, True),     # 144 tokens, kd != dv
    (2, 21, 14, 7, 2, 16, 64, "qkv_major", False, True),     # 49 tokens, kd 16, dv 64
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


def _offset_view(t):
    """A contiguous copy of t whose data starts 2 bytes past a 16-byte
    boundary (a view with a storage offset)."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16
    return view


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_take_unaligned_views(card, dtype):
    """qkv, qkv_bias and dout as contiguous views that do not start on a
    16-byte boundary: the same results as on aligned copies, and the plain
    version's within the bounds."""
    B, H, W, ws, heads, kd, dv = 2, 14, 14, 7, 3, 32, 32
    rng = np.random.default_rng(4)
    qkv, bias, _, qb = _inputs(rng, B, H, W, ws, heads, kd, dv, False, True, card)
    qkv, qb = qkv.to(dtype), qb.to(dtype)
    dout = torch.from_numpy(rng.standard_normal((B, H, W, heads * dv)).astype(
        np.float32)).to(card, dtype)
    kw = dict(window=ws, heads=heads, kd=kd, dv=dv)
    with torch.inference_mode():
        got = wa.fused_window_attention(_offset_view(qkv), bias, qkv_bias=_offset_view(qb), **kw)
        aligned = wa.fused_window_attention(qkv, bias, qkv_bias=qb, **kw)
        want = wa.window_attention_ref(qkv, bias, qkv_bias=qb, **kw)
    assert torch.equal(got, aligned)
    assert (got.float() - want.float()).abs().max().item() <= _bound(dtype, want.float())
    got = wa.fused_window_attention_bwd(_offset_view(qkv), bias, None, _offset_view(dout),
                                        qkv_bias=_offset_view(qb), **kw)
    aligned = wa.fused_window_attention_bwd(qkv, bias, None, dout, qkv_bias=qb, **kw)
    want = wa.window_attention_bwd_ref(qkv, bias, None, dout, qkv_bias=qb, **kw)
    assert torch.equal(got[0], aligned[0]) and torch.equal(got[1], aligned[1])
    err = (got[0].float() - want[0].float()).abs().max().item()
    assert err <= _bwd_bound(dtype, want[0].float()), err


def test_bwd_bf16_same_bits_on_two_launches_at_196_tokens(card):
    """bf16 K2 at TinyViT-21M's stage-2 window (N = 196) with enough windows
    that a block walks several of them (its dbias partial is added to, not
    only stored): dqkv and dbias are the same bits on two launches."""
    B, H, W, ws, heads, kd, dv = 128, 14, 14, 14, 12, 32, 32
    rng = np.random.default_rng(5)
    qkv, bias, _, qb = _inputs(rng, B, H, W, ws, heads, kd, dv, False, True, card)
    qkv = qkv.bfloat16()
    dout = torch.from_numpy(rng.standard_normal((B, H, W, heads * dv)).astype(
        np.float32)).to(card, torch.bfloat16)
    kw = dict(window=ws, heads=heads, kd=kd, dv=dv, qkv_bias=qb)
    per_group, _ = wa._bwd_groups(B, heads, ws * ws, qkv.device)
    assert per_group > 1
    first = wa.fused_window_attention_bwd(qkv, bias, None, dout, **kw)
    second = wa.fused_window_attention_bwd(qkv, bias, None, dout, **kw)
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])
    want = wa.window_attention_bwd_ref(qkv, bias, None, dout, **kw)
    err = (first[0].float() - want[0].float()).abs().max().item()
    assert err <= _bwd_bound(torch.bfloat16, want[0].float()), err
    torch.testing.assert_close(first[1], want[1], atol=1e-4 * want[1].abs().max().item(),
                               rtol=0)


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


# every (N, d) of M0-M5's heads (16..112 at 49 and 16 tokens) and the img-96 windows
K5_CASES = sorted({(ws * ws, C // h) for _, ws, C, h, _ in CGA_STAGES}
                  | {(N, d) for N in (16, 49) for d in range(16, 113, 16)})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,d", K5_CASES)
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


def _k4_case(card, C, heads, ws, kernels, nw, dtype, seed=0, kd=16):
    m = CascadedGroupAttention(C, kd, heads, C / (kd * heads), ws, kernels,
                               device=card, dtype=dtype).eval()
    m.load_state_dict(seeded_state_dict(m, C + ws + seed))
    g = torch.Generator(card).manual_seed(nw + seed)
    x = torch.randn(nw, ws, ws, C, generator=g, device=card).to(dtype)
    kw = dict(ws=ws, heads=heads, c_in=C // heads, kd=kd, d=C // heads, ks_max=m.ks_max)
    return (x, m.attention_biases, m.attention_bias_idxs, *cga.fold_cga_variables(m, dtype)), kw


def _k4_check(ops, kw, windows=None):
    """K4 (at `windows` windows a block, else the plan's) against its plain
    version: one launch, finite, within 8 bf16 ulps (fp32: 1e-5) at max |out|."""
    before = cga.LAUNCHES
    with torch.inference_mode():
        if windows is None:
            got = cga.fused_cga(*ops, **kw)
        else:
            kw1 = {k: v for k, v in kw.items() if k != "c_in"}
            got = cga._launch(*ops, windows, **kw1)
        torch.cuda.synchronize()
        want = cga.fused_cga_ref(*ops, **kw)
    assert cga.LAUNCHES == before + 1
    assert got.shape == ops[0].shape and got.dtype == ops[0].dtype
    assert bool(torch.isfinite(got).all())
    err = (got.float() - want.float()).abs().max().item()
    assert err <= _cga_bound(ops[0].dtype, want.float(), 8), err
    return got


def _k4_windows(ws, C, heads, kernels):
    """The windows a bf16 block can take at a stage: every G whose block
    fits two an SM (the plan picks among them), at least 1."""
    d, ks = C // heads, max(kernels[:heads])
    return [G for G in range(1, cga.MAX_WINDOWS + 1)
            if G == 1 or cga._fits_pair(ws, heads, 16, d, ks, G)]


# every stage at every G its blocks can take, with window counts that leave
# the last block short: 1, 3 and G + 1
K4_RAGGED = [(name, ws, C, heads, kernels, G, nw)
             for name, ws, C, heads, kernels in CGA_STAGES
             for G in _k4_windows(ws, C, heads, kernels) for nw in sorted({1, 3, G + 1})]


@pytest.mark.parametrize("name,ws,C,heads,kernels,G,nw", K4_RAGGED)
def test_k4_bf16_ragged_last_block(card, name, ws, C, heads, kernels, G, nw):
    ops, kw = _k4_case(card, C, heads, ws, kernels, nw, torch.bfloat16)
    _k4_check(ops, kw, windows=G)


@pytest.mark.parametrize("name,ws,C,heads,kernels", CGA_STAGES)
def test_k4_bf16_same_bits_at_every_block_size(card, name, ws, C, heads, kernels):
    """No sum's order depends on the windows a block takes: 2 G + 1 windows
    give the same bits at every G."""
    gs = _k4_windows(ws, C, heads, kernels)
    ops, kw = _k4_case(card, C, heads, ws, kernels, 2 * max(gs) + 1, torch.bfloat16)
    kw1 = {k: v for k, v in kw.items() if k != "c_in"}
    with torch.inference_mode():
        outs = [cga._launch(*ops, G, **kw1) for G in gs]
    assert all(torch.equal(o, outs[0]) for o in outs[1:]), gs


# ks_max above ws (4x4 and 2x2 windows with 7x7 taps), head dims whose
# padding to 16 columns is nonzero (kd 8 and 24, d 24 and 40: the zero
# columns of x, q, k and the weights), one head, the largest C
K4_SHAPES = [(4, 64, 4, (7, 7, 7, 7), 16), (2, 64, 2, (7, 7), 16), (7, 72, 3, (5, 3, 3), 8),
             (7, 80, 2, (3, 5), 24), (6, 40, 1, (7,), 16), (7, 384, 4, (7, 5, 3, 3), 16),
             (8, 128, 2, (5, 5), 16), (3, 96, 3, (7, 5, 3), 16)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ws,C,heads,kernels,kd", K4_SHAPES)
def test_k4_other_shapes(card, dtype, ws, C, heads, kernels, kd):
    ops, kw = _k4_case(card, C, heads, ws, kernels, 2 * cga.MAX_WINDOWS + 1, dtype, kd=kd)
    _k4_check(ops, kw)
    if dtype == torch.bfloat16:
        for G in (2, 3):                        # blocks of several windows, the last short
            if cga._bf16_smem(ws, heads, kd, C // heads, max(kernels[:heads]), G) <= cga.SMEM_LIMIT:
                _k4_check(ops, kw, windows=G)


@pytest.mark.parametrize("name,ws,C,heads,kernels", CGA_STAGES)
def test_k4_bf16_same_bits_on_two_launches(card, name, ws, C, heads, kernels):
    """Every sum's order depends on the shape alone: two launches on the same
    inputs give the same bits."""
    ops, kw = _k4_case(card, C, heads, ws, kernels, 13, torch.bfloat16)
    with torch.inference_mode():
        assert torch.equal(cga.fused_cga(*ops, **kw), cga.fused_cga(*ops, **kw))


def test_k4_plan_is_the_librarys(card):
    """`launch_plan` (Python) against the built kernel's `cream_cga_plan` at
    every stage shape and every window up to 8 with heads * d <= 384, at
    several window counts."""
    shapes = [(ws, h, C // h, max(k[:h])) for _, ws, C, h, k in CGA_STAGES]
    shapes += [(ws, h, d, ks) for ws in range(1, 9) for h in (1, 2, 3, 4, 6, 8)
               for d in range(8, 384 // h + 1, 8) for ks in (3, 7)]
    for ws, heads, d, ks in shapes:
        for nw in (1, 512, 1000, 4096):
            for dtype in (torch.bfloat16, torch.float32):
                lib = cga.library_plan(nw, ws, heads, 16, d, ks, dtype)
                try:
                    assert cga.launch_plan(nw, ws, heads, 16, d, ks, dtype) == lib
                except ValueError:
                    assert lib.windows == 0 or lib.smem > cga.SMEM_LIMIT


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
    with pytest.raises(ValueError):                          # bf16 d not a multiple of 8
        odd = _seeded_cga(60, 3, 7, (3, 3, 3), card, torch.bfloat16)
        cga.fused_cga(torch.zeros(1, 7, 7, 60, device=card, dtype=torch.bfloat16),
                      odd.attention_biases, odd.attention_bias_idxs,
                      *cga.fold_cga_variables(odd, torch.bfloat16), ws=7, heads=3, c_in=20,
                      kd=16, d=20, ks_max=3)


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


# (B, H, W, C, stride): M5's depthwise sites, TinyViT-21M's MBConv,
# local_conv and PatchMerging sites (batches cut), odd C (one bf16 channel
# per thread), odd stride-2 maps (the kernels take them; ConvBN routes them
# to the library: K9's backward skips dx rows and columns past H and W and
# dy taps past Ho and Wo), a map whose tiles are ragged in H, W and C
# (staged element by element in the backward), the smallest maps K7 and K9
# take
DW_CASES = [(4, 14, 14, 192, 1), (16, 7, 7, 16, 1), (4, 7, 7, 288, 1), (4, 4, 4, 384, 1),
            (8, 4, 4, 16, 1), (2, 56, 56, 384, 1), (4, 14, 14, 768, 2), (2, 56, 56, 192, 2),
            (2, 14, 14, 576, 2), (3, 9, 6, 15, 1), (3, 8, 6, 15, 2), (2, 7, 7, 16, 2),
            (2, 28, 28, 192, 1), (2, 14, 14, 384, 1), (2, 7, 7, 576, 1), (2, 57, 35, 40, 1),
            (1, 1, 2, 8, 1), (2, 28, 28, 384, 2), (2, 9, 13, 24, 2), (1, 2, 4, 8, 2)]


def _dw_inputs(card, B, H, W, C, stride, dtype):
    g = torch.Generator(card).manual_seed(B * H * C + stride)
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    x = torch.randn(B, H, W, C, generator=g, device=card).to(dtype)
    w9 = (torch.randn(9, C, generator=g, device=card) / 3).to(dtype)
    dy = torch.randn(B, Ho, Wo, C, generator=g, device=card).to(dtype)
    return x, w9, dy


def _dw_close(got, want, dtype, rel):
    """bf16: one ulp at the largest |want| (the same rounding points); fp32:
    `rel` of the largest |want|."""
    top = want.float().abs().max().item()
    lim = 2.0 ** (np.floor(np.log2(top)) - 7) if dtype == torch.bfloat16 else rel * top
    err = (got.float() - want.float()).abs().max().item()
    assert err <= lim, (err, lim)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,C,stride", DW_CASES)
def test_dw_kernels_match_plain(card, dtype, B, H, W, C, stride):
    _check_dw_kernels(card, dtype, B, H, W, C, stride)


# Cream's depthwise 3x3 sites at 224 (B = 2): the depthwise-separable block
# and every k3 choice, 16·e to 192·e channels (models.cream.dw3x3_sites)
CREAM_DW_CASES = [(*shape, stride) for stride, shape in dw3x3_sites(batch=2)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,C,stride", CREAM_DW_CASES)
def test_dw_kernels_match_plain_at_cream_sites(card, dtype, B, H, W, C, stride):
    _check_dw_kernels(card, dtype, B, H, W, C, stride)


def _check_dw_kernels(card, dtype, B, H, W, C, stride):
    x, w9, dy = _dw_inputs(card, B, H, W, C, stride, dtype)
    n = dict(dwconv.LAUNCHES)
    fwd, bwd = ("k7_fwd", "k7_bwd") if stride == 1 else ("k9_fwd", "k9_bwd")
    y = dwconv.dw_conv3x3_fwd(x, w9, stride)
    dx, dw = dwconv.dw_conv3x3_bwd(x, dy, w9, stride)
    dx2, dw2 = dwconv.dw_conv3x3_bwd(x, dy, w9, stride)
    torch.cuda.synchronize()
    assert dwconv.LAUNCHES[fwd] == n[fwd] + 1 and dwconv.LAUNCHES[bwd] == n[bwd] + 2
    y_ref = dwconv.dw_conv3x3_ref(x, w9, stride)
    dx_ref, dw_ref = dwconv.dw_conv3x3_bwd_ref(x, dy, w9, stride)
    assert y.dtype == dx.dtype == dtype and dw.dtype == torch.float32
    # y and dx: the plain version's products and sums, in its order
    _dw_close(y, y_ref, dtype, 1e-6)
    _dw_close(dx, dx_ref, dtype, 1e-6)
    # dw: up to B*Ho*Wo fp32 terms summed in another order
    _dw_close(dw, dw_ref, torch.float32, 1e-5)
    assert torch.equal(dw, dw2) and torch.equal(dx, dx2)        # the same bits
    if stride == 1:
        dw8 = dwconv.dw_wgrad(x, dy)
        torch.cuda.synchronize()
        assert dwconv.LAUNCHES["k8"] == n["k8"] + 1
        assert torch.equal(dw8, dw)                 # K8 is K7's dw pass alone


@pytest.mark.parametrize("fn,stride", [(dwconv.dw_conv3x3_fused, 1), (dwconv.dw_conv3x3_wg, 1),
                                       (dwconv.dw_conv3x3s2_fused, 2)])
def test_dw_functions_grads_match_autograd_of_plain(card, fn, stride):
    x, w9, dy = _dw_inputs(card, 2, 10, 12, 24, stride, torch.float32)
    leaves = [x.clone().requires_grad_(), w9.clone().requires_grad_()]
    got = torch.autograd.grad(fn(*leaves), leaves, dy)
    plain = [x.clone().requires_grad_(), w9.clone().requires_grad_()]
    want = torch.autograd.grad(dwconv.dw_conv3x3_ref(*plain, stride), plain, dy)
    for g, w in zip(got, want):
        assert ((g - w).abs().max() / w.abs().max()).item() <= 1e-5


def test_dw_kernels_refuse_what_they_do_not_take(card):
    x = torch.zeros(2, 8, 8, 16, device=card)
    w9 = torch.zeros(9, 16, device=card)
    with pytest.raises(TypeError):                            # fp16 is not built
        dwconv.dw_conv3x3_fwd(x.half(), w9.half())
    with pytest.raises(ValueError):                           # strided x
        dwconv.dw_conv3x3_fwd(x.transpose(1, 2), w9)
    with pytest.raises(ValueError):                           # dy on the CPU
        dwconv.dw_conv3x3_bwd(x, torch.zeros(2, 8, 8, 16), w9)
    with pytest.raises(TypeError):                            # dy of another dtype
        dwconv.dw_wgrad(x, torch.zeros(2, 8, 8, 16, device=card).bfloat16())


@pytest.mark.parametrize("stride", [1, 2])
def test_dw_backward_refuses_a_plan_it_cannot_take(card, stride):
    """A plan the C entry refuses (channels per tile not dividing C, too
    many threads, no groups) raises; nothing falls back."""
    x, w9, dy = _dw_inputs(card, 2, 14, 14, 192, stride, torch.bfloat16)
    plan = (dwconv.tile_plan(x.shape, x.dtype, backward=True) if stride == 1
            else dwconv.tile_plan_s2(x.shape, x.dtype))
    dwconv._bwd_launch(x, dy, w9, stride, True, plan)            # the plan itself runs
    for bad in (plan._replace(cb=plan.cb + plan.vec), plan._replace(ni=64),
                plan._replace(groups=0)):
        with pytest.raises(RuntimeError, match="cudaError"):
            dwconv._bwd_launch(x, dy, w9, stride, True, bad)


def test_narrow_efficientvit_train_step_routes_agree(card):
    """fp32, TF32 off, img 128 (maps 8/4/2: both subsample depthwise convs
    stride-2 eligible): one train step's loss and grads on the "fused" and
    "wgrad" routes against "library" on the same weights and batch, and the
    launches the depthwise sites give."""
    from cream_tpu_torch.train.losses import soft_target_ce
    from cream_tpu_torch.train.steps import loss_and_grads
    m = EfficientViT(img_size=128, device=card, **EVIT_NARROW)
    sd = seeded_state_dict(m, 5)
    s1 = sum(isinstance(c, ConvBN) and c.is_dw3x3() and c.stride == 1 for c in m.modules())
    rng = np.random.default_rng(8)
    batch = {"image": torch.from_numpy(rng.standard_normal((4, 128, 128, 3)).astype(
        np.float32)).to(card), "label": torch.from_numpy(np.eye(10, dtype=np.float32)[
            rng.integers(0, 10, 4)]).to(card)}
    out = {}
    for route, want in (("library", {}), ("fused", {"k7_fwd": s1, "k7_bwd": s1, "k9_fwd": 2,
                                                    "k9_bwd": 2}), ("wgrad", {"k8": s1})):
        m = EfficientViT(img_size=128, device=card, dw_kernel=route, **EVIT_NARROW)
        m.load_state_dict(sd)
        dwconv.reset_launches()
        out[route] = loss_and_grads(m, batch, soft_target_ce)
        torch.cuda.synchronize()
        assert dwconv.LAUNCHES == {k: want.get(k, 0) for k in dwconv.LAUNCHES}, route
    loss, _, grads = out["library"]
    norm = torch.sqrt(sum(g.pow(2).sum() for g in grads.values())).item()
    for route in ("fused", "wgrad"):
        torch.testing.assert_close(out[route][0], loss, rtol=1e-5, atol=0)
        got = out[route][2]
        # relative L2 1e-3 per tensor (ReLU inputs within fp32 noise of 0
        # move a few grads by ~1e-3), at 1e-6 of the global norm for grads
        # at float noise
        for k, w in grads.items():
            err = (got[k] - w).norm().item()
            assert err <= 1e-3 * w.norm().item() + 1e-6 * norm, (route, k, err)


# ---- K6 fused eval MBConv, K3 bias attention, K10 window relayout, K11 layout pin

def _seeded_mbconv(card, C, hid, seed):
    from cream_tpu_torch.nn.layers import MBConv
    m = MBConv(C, hid / C, device=card).eval()
    m.load_state_dict(seeded_state_dict(m, seed))
    return m


# (B, H, W, C, HID): TinyViT-21M's and -5M/11M's stage-0 maps (batches cut),
# maps that are not whole 8x8 tiles, the other built channel counts; maps
# that cut 14x14 tiles (bf16) raggedly, a map smaller than one tile and a
# 1x1 map
K6_CASES = [(2, 56, 56, 96, 384), (2, 56, 56, 64, 256), (3, 9, 13, 32, 64),
            (1, 20, 12, 128, 512), (2, 7, 7, 96, 96), (2, 15, 15, 32, 64),
            (1, 57, 35, 64, 256), (2, 1, 1, 96, 384)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,C,HID", K6_CASES)
def test_k6_matches_plain(card, dtype, B, H, W, C, HID):
    from cream_tpu_torch.ops import mbconv
    m = _seeded_mbconv(card, C, HID, seed=C + H)
    ops = mbconv.fold_mbconv(m, dtype)
    g = torch.Generator(card).manual_seed(B * H * W)
    x = torch.randn(B, H, W, C, generator=g, device=card).to(dtype)
    n = mbconv.LAUNCHES
    out = mbconv.fused_mbconv(x, *ops)
    torch.cuda.synchronize()
    assert mbconv.LAUNCHES == n + 1 and out.dtype == dtype and out.shape == x.shape
    ref = mbconv.fused_mbconv_ref(x, *ops)
    # bf16: h, h2 and y round at the same points, the fp32 products sum in
    # other orders (2 ulps at max); fp32: 1e-5 of the largest |y|
    assert (out.float() - ref.float()).abs().max().item() <= _bound(dtype, ref.float())


def test_k6_zero_pads_the_hidden_tensor(card):
    """A large b1: taps outside the image must read 0, not GELU(b1)."""
    from cream_tpu_torch.ops import mbconv
    m = _seeded_mbconv(card, 32, 128, seed=3)
    w1, b1, dw, bdw, w2, b2 = mbconv.fold_mbconv(m, torch.float32)
    b1 = torch.full_like(b1, 3.0)
    x = torch.randn(2, 8, 8, 32, device=card)
    out = mbconv.fused_mbconv(x, w1, b1, dw, bdw, w2, b2)
    ref = mbconv.fused_mbconv_ref(x, w1, b1, dw, bdw, w2, b2)
    assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


def test_k6_zero_pads_the_hidden_tensor_bf16(card):
    """The same in bf16, whose kernel zeroes h outside the image in its own
    staging of the 16x16 halo: a ragged 15x15 map puts the zero rows on
    both sides of a tile."""
    from cream_tpu_torch.ops import mbconv
    m = _seeded_mbconv(card, 32, 128, seed=3)
    w1, b1, dw, bdw, w2, b2 = mbconv.fold_mbconv(m, torch.bfloat16)
    b1 = torch.full_like(b1, 3.0)
    x = torch.randn(2, 15, 15, 32, device=card).bfloat16()
    out = mbconv.fused_mbconv(x, w1, b1, dw, bdw, w2, b2)
    ref = mbconv.fused_mbconv_ref(x, w1, b1, dw, bdw, w2, b2)
    assert (out.float() - ref.float()).abs().max().item() <= _bound(torch.bfloat16, ref.float())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k6_two_launches_give_the_same_bits(card, dtype):
    """Fixed tiles and fixed sum orders: the kernel is deterministic."""
    from cream_tpu_torch.ops import mbconv
    m = _seeded_mbconv(card, 96, 384, seed=4)
    ops = mbconv.fold_mbconv(m, dtype)
    x = torch.randn(3, 30, 23, 96, device=card).to(dtype)
    assert torch.equal(mbconv.fused_mbconv(x, *ops), mbconv.fused_mbconv(x, *ops))


def test_k6_takes_an_offset_view(card):
    """bf16 x that does not start on a 16-byte boundary (the tensor-core
    path reads x 16 bytes at a time): the wrapper copies it first."""
    from cream_tpu_torch.ops import mbconv
    m = _seeded_mbconv(card, 96, 384, seed=2)
    ops = mbconv.fold_mbconv(m, torch.bfloat16)
    flat = torch.randn(2 * 9 * 9 * 96 + 1, device=card).bfloat16()
    x = flat[1:].view(2, 9, 9, 96)
    ref = mbconv.fused_mbconv_ref(x, *ops)
    out = mbconv.fused_mbconv(x, *ops)
    assert (out.float() - ref.float()).abs().max().item() <= _bound(torch.bfloat16, ref.float())


def test_k6_module_route_and_refusals(card):
    from cream_tpu_torch.nn.layers import set_mbconv_kernel
    from cream_tpu_torch.ops import mbconv
    m = _seeded_mbconv(card, 64, 256, seed=1)
    x = torch.randn(2, 14, 14, 64, device=card)
    with torch.inference_mode():
        want = m(x)
        set_mbconv_kernel(m, True)
        n = mbconv.LAUNCHES
        got = m(x)
        assert mbconv.LAUNCHES == n + 1
    # fp32, TF32 off: BN folded vs applied, sums in other orders
    torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-4)
    ops = mbconv.fold_mbconv(m, torch.float32)
    with pytest.raises(ValueError):                       # strided x
        mbconv.fused_mbconv(x.transpose(1, 2), *ops)
    with pytest.raises(ValueError):                       # C = 48 is not built
        mbconv.fused_mbconv(torch.zeros(1, 4, 4, 48, device=card),
                            *mbconv.fold_mbconv(_seeded_mbconv(card, 48, 192, 0), torch.float32))


# (W, heads, N, kd, dv): TinyViT-21M's per-window shapes at bs256 cut, the
# 196-token window, EfficientViT's 16-token window, 256 tokens, kd != dv;
# then head dims that are not multiples of 16 (the tensor-core path pads
# them) or of 8 (element loads and stores), items that do not fill the
# last block (4 a block at 16 tokens, 2 at 32)
K3_CASES = [(64, 6, 49, 32, 32), (16, 12, 196, 32, 32), (40, 3, 16, 16, 16),
            (4, 2, 256, 32, 32), (8, 4, 49, 16, 64), (5, 2, 100, 64, 32),
            (6, 2, 30, 12, 20), (7, 3, 32, 24, 7), (9, 3, 16, 8, 8), (3, 2, 144, 48, 80)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("W,h,N,kd,dv", K3_CASES)
def test_k3_matches_plain(card, dtype, W, h, N, kd, dv):
    from cream_tpu_torch.ops import bias_attention as ba
    g = torch.Generator(card).manual_seed(W * N + kd)
    q, k = (torch.randn(W, h, N, kd, generator=g, device=card).to(dtype) for _ in range(2))
    v = torch.randn(W, h, N, dv, generator=g, device=card).to(dtype)
    bias = torch.randn(h, N, N, generator=g, device=card)
    n = ba.LAUNCHES
    out = ba.fused_bias_attention(q, k, v, bias)
    torch.cuda.synchronize()
    assert ba.LAUNCHES == n + 1 and out.shape == (W, h, N, dv) and out.dtype == dtype
    ref = ba.fused_bias_attention_ref(q, k, v, bias)
    assert (out.float() - ref.float()).abs().max().item() <= _bound(dtype, ref.float())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_k5_take_offset_views(card, dtype):
    """q, k and v that do not start on a 16-byte boundary (the bf16 path
    stages them 16 bytes at a time): the wrappers copy them first."""
    from cream_tpu_torch.ops import bias_attention as ba
    g = torch.Generator(card).manual_seed(3)

    def view(*shape):
        flat = torch.randn(int(np.prod(shape)) + 1, generator=g, device=card).to(dtype)
        return flat[1:].view(*shape)
    q, k, v = view(8, 3, 49, 32), view(8, 3, 49, 32), view(8, 3, 49, 16)
    bias = torch.randn(3, 49, 49, generator=g, device=card)
    ref = ba.fused_bias_attention_ref(q, k, v, bias)
    out = ba.fused_bias_attention(q, k, v, bias)
    assert (out.float() - ref.float()).abs().max().item() <= _bound(dtype, ref.float())
    q, k, v = view(37, 49, 16), view(37, 49, 16), view(37, 49, 64)
    ref = cga_core.cga_attention_ref(q, k, v, bias[0], 0.25)
    out = cga_core.cga_attention(q, k, v, bias[0], 0.25)
    assert (out.float() - ref.float()).abs().max().item() <= _bound(dtype, ref.float())


@pytest.mark.parametrize("N,d", [(49, 32), (196, 32), (16, 16)])
def test_k3_k5_bf16_same_bits_on_two_launches(card, N, d):
    """No sum in either kernel depends on the launch: two launches on the
    same inputs give the same bits."""
    from cream_tpu_torch.ops import bias_attention as ba
    g = torch.Generator(card).manual_seed(N)
    q, k, v = (torch.randn(32, 4, N, d, generator=g, device=card).bfloat16() for _ in range(3))
    bias = torch.randn(4, N, N, generator=g, device=card)
    assert torch.equal(ba.fused_bias_attention(q, k, v, bias),
                       ba.fused_bias_attention(q, k, v, bias))
    if N <= cga_core.MAX_TOKENS:
        q, k, v = (t.flatten(0, 1).contiguous() for t in (q, k, v))
        assert torch.equal(cga_core.cga_attention(q, k, v, bias[0], 0.25),
                           cga_core.cga_attention(q, k, v, bias[0], 0.25))


def test_k3_module_route_and_refusals(card):
    from cream_tpu_torch.nn.attention import BiasAttention
    from cream_tpu_torch.ops import bias_attention as ba
    m = BiasAttention(64, 16, 4, device=card).eval()
    m.load_state_dict(seeded_state_dict(m, 2))
    x = torch.randn(8, 49, 64, device=card)
    with torch.inference_mode():
        n = ba.LAUNCHES
        got = m(x)
        assert ba.LAUNCHES == n + 1
        m.use_kernel = False
        want = m(x)
        assert ba.LAUNCHES == n + 1
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    q = torch.zeros(2, 2, 16, 8, device=card)
    with pytest.raises(TypeError):                        # fp16 is not built
        ba.fused_bias_attention(q.half(), q.half(), q.half(), torch.zeros(2, 16, 16, device=card))
    with pytest.raises(ValueError):                       # 257 tokens
        z = torch.zeros(1, 1, 257, 8, device=card)
        ba.fused_bias_attention(z, z, z, torch.zeros(1, 257, 257, device=card))
    with pytest.raises(ValueError):                       # strided q
        ba.fused_bias_attention(q.transpose(0, 1), q, q, torch.zeros(2, 16, 16, device=card))


# (B, H, W, ws, C, dtype): TinyViT-21M-384's stage-2 map, a stage-1 map, a
# channel count that allows only 4-byte (bf16) or 8-byte accesses
K10_CASES = [(4, 24, 24, 24, 384, torch.bfloat16), (8, 28, 28, 7, 192, torch.bfloat16),
             (2, 12, 8, 4, 6, torch.bfloat16), (3, 14, 21, 7, 10, torch.float32),
             (2, 16, 16, 8, 64, torch.float32)]


@pytest.mark.parametrize("B,H,W,ws,C,dtype", K10_CASES)
def test_k10_matches_plain_exactly(card, B, H, W, ws, C, dtype):
    from cream_tpu_torch.ops import window_relayout as wr
    x = torch.randn(B, H, W, C, device=card).to(dtype)
    n = wr.LAUNCHES
    w = wr.window_partition_kernel(x, ws)
    back = wr.window_reverse_kernel(w, ws, (H, W))
    torch.cuda.synchronize()
    assert wr.LAUNCHES == n + 2
    assert w.is_contiguous() and back.is_contiguous()
    assert torch.equal(w, wr.window_partition_ref(x, ws))
    assert torch.equal(back, x)
    # an offset view: 2-byte aligned only
    flat = torch.randn(B * H * W * C + 1, device=card).to(dtype)
    xo = flat[1:].view(B, H, W, C)
    assert torch.equal(wr.window_partition_kernel(xo, ws), wr.window_partition_ref(xo, ws))


def test_k10_route_in_forward_windowed(card):
    """A whole-window map beyond 256 tokens: eval on the card partitions and
    reverses through K10, and matches the plain partition bit for bit."""
    from cream_tpu_torch.ops import window_relayout as wr
    m = WindowBiasAttention(64, 32, 2, 18, device=card).eval()
    m.load_state_dict(seeded_state_dict(m, 4))
    x = torch.randn(2, 18, 18, 64, device=card)
    with torch.inference_mode():
        n = wr.LAUNCHES
        got = m(x)
        assert wr.LAUNCHES == n + 2
        m.use_kernel = False
        want = m(x)
        assert wr.LAUNCHES == n + 2
    assert torch.equal(got, want)
    with pytest.raises(ValueError):
        wr.window_partition_kernel(torch.zeros(1, 13, 14, 8, device=card), 7)


@pytest.mark.parametrize("shape,dtype", [((4, 28, 28, 192), torch.bfloat16),
                                         ((4, 7, 7, 576), torch.float32),
                                         ((3, 5, 7), torch.bfloat16), ((7,), torch.float32)])
def test_k11_copies_exactly(card, shape, dtype):
    from cream_tpu_torch.ops import layout_pin as lp
    x = torch.randn(shape, device=card).to(dtype)
    n = lp.LAUNCHES
    y = lp.layout_pin(x)
    torch.cuda.synchronize()
    assert lp.LAUNCHES == n + 1 and y.data_ptr() != x.data_ptr() and torch.equal(y, x)
    xr = x.clone().requires_grad_() if dtype == torch.float32 else None
    if xr is not None:
        dy = torch.randn_like(x)
        (g,) = torch.autograd.grad(lp.layout_pin(xr), xr, dy)
        assert torch.equal(g, dy) and lp.LAUNCHES == n + 2     # no copy in the backward
    with pytest.raises(ValueError):
        lp.layout_pin(torch.zeros(4, 6, device=card).t())


def test_narrow_tinyvit_pin_and_mbconv_routes(card):
    """fp32, TF32 off: pin_layouts gives the same logits bit for bit with 3
    K11 launches; mbconv_kernel agrees with the module path with one K6
    launch per MBConv."""
    from cream_tpu_torch.ops import layout_pin as lp
    from cream_tpu_torch.ops import mbconv
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, 112, 112, 3)).astype(np.float32)).to(card)
    out = {}
    for key, kw in (("plain", {}), ("pin", {"pin_layouts": True}),
                    ("mbconv", {"mbconv_kernel": True})):
        m = TinyViT(img_size=112, device=card, **kw, **NARROW).eval()
        m.load_state_dict(seeded_state_dict(m, 5))
        n = (lp.LAUNCHES, mbconv.LAUNCHES)
        with torch.inference_mode():
            out[key] = m(x)
        want = {"plain": (0, 0), "pin": (3, 0),
                "mbconv": (0, NARROW["depths"][0])}[key]
        assert (lp.LAUNCHES - n[0], mbconv.LAUNCHES - n[1]) == want, key
    assert torch.equal(out["pin"], out["plain"])
    torch.testing.assert_close(out["mbconv"], out["plain"], atol=1e-4, rtol=1e-4)


# S3-Tiny's four stages at 224: (map, window, dim, heads, shift); head dim 32
S3T_STAGES = [(56, 7, 96, 3, 3), (28, 7, 192, 6, 3), (14, 14, 384, 12, 0), (7, 7, 768, 24, 0)]


# Swin-B's four stages at 224 (the distillation teacher): heads 4/8/16/32
# of width 32, the shift mask at stages 0-2 (stage 2: 14x14, window 7)
SWINB_STAGES = [(56, 7, 128, 4, 3), (28, 7, 256, 8, 3), (14, 7, 512, 16, 3),
                (7, 7, 1024, 32, 0)]


@pytest.mark.parametrize("H,ws,dim,heads,shift", S3T_STAGES)
def test_swin_attention_kernel_route_matches_plain(card, H, ws, dim, heads, shift):
    """`SwinWindowAttention` through `swin_attend` at S3-Tiny's stage shapes
    (batch 2): bf16 and fp32 forwards on K1 (qkv_major, in-kernel qkv bias,
    the shift mask) against the plain route; in fp32, the grads of x, the
    bias table, the qkv weight and bias through K2 against autograd of the
    plain route. One K1 launch a forward, one K2 a backward."""
    _swin_attention_case(card, H, ws, dim, heads, shift)


@pytest.mark.parametrize("H,ws,dim,heads,shift", SWINB_STAGES)
def test_swin_base_attention_kernel_route_matches_plain(card, H, ws, dim, heads, shift):
    """The same at Swin-B's stage shapes: 16 heads on the masked 14x14 map
    (4 windows), 32 heads on stage 3's one window."""
    _swin_attention_case(card, H, ws, dim, heads, shift)


def _swin_attention_case(card, H, ws, dim, heads, shift):
    import copy

    from cream_tpu_torch.nn.swin import SwinWindowAttention, swin_attend
    for dtype in (torch.bfloat16, torch.float32):
        attn = SwinWindowAttention(dim, ws, heads, head_dim=32, dtype=dtype, device=card)
        attn.load_state_dict(seeded_state_dict(attn, 1))
        plain = copy.deepcopy(attn)
        plain.use_kernel = False
        x = torch.from_numpy(np.random.default_rng(2).standard_normal(
            (2, H, H, dim)).astype(np.float32)).to(card)
        assert attn.kernel_path(x) and not plain.kernel_path(x)
        k1, k2 = wa.LAUNCHES, wa.BWD_LAUNCHES
        xk, xp = x.clone().requires_grad_(), x.clone().requires_grad_()
        got = swin_attend(xk.to(dtype), attn, ws, shift)
        want = swin_attend(xp.to(dtype), plain, ws, shift)
        assert wa.LAUNCHES == k1 + 1
        # four times K1's bound: the output projection rounds once more
        lim = 4 * _bound(dtype, want.float())
        assert (got.float() - want.float()).abs().max().item() <= lim
        if dtype == torch.float32:
            dout = torch.randn_like(got)
            params = [attn.relative_position_bias_table, attn.qkv.weight, attn.qkv.bias]
            g = torch.autograd.grad(got, [xk, *params], dout)
            pp = [plain.relative_position_bias_table, plain.qkv.weight, plain.qkv.bias]
            w = torch.autograd.grad(want, [xp, *pp], dout)
            assert wa.BWD_LAUNCHES == k2 + 1
            for a, b in zip(g, w):
                torch.testing.assert_close(a, b, atol=1e-5 * b.abs().max().item(), rtol=0)


@pytest.mark.parametrize("name,per", [("s3_tiny", 12), ("swin_tiny", 12), ("mini_swin_tiny", 0),
                                      ("swin_base", 24)])
def test_swin_models_kernel_launches_and_plain_route(card, name, per):
    """fp32 (TF32 off) at batch 2: `per` K1 launches a forward, logits
    within 1e-4 of the plain route's; S3-Tiny's train step launches 12 K1
    + 12 K2 and its loss and grads agree with the plain route's."""
    import copy

    from cream_tpu_torch.models import create_model
    from cream_tpu_torch.train.losses import soft_target_ce
    from cream_tpu_torch.train.steps import loss_and_grads

    m = create_model(name, device=card, drop_path_rate=0.0)
    m.load_state_dict(seeded_state_dict(m, 0))
    plain = copy.deepcopy(m)
    _set_swin_kernel(plain, False)
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((2, 224, 224, 3)).astype(np.float32)).to(card)
    k1 = wa.LAUNCHES
    with torch.inference_mode():
        got = m(x)
        assert wa.LAUNCHES == k1 + per
        want = plain(x)
    assert wa.LAUNCHES == k1 + per
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    if name != "s3_tiny":
        return
    y = torch.eye(1000, device=card)[torch.from_numpy(rng.integers(0, 1000, 2)).to(card)]
    k1, k2 = wa.LAUNCHES, wa.BWD_LAUNCHES
    loss, _, grads = loss_and_grads(m, {"image": x, "label": y}, soft_target_ce)
    assert (wa.LAUNCHES - k1, wa.BWD_LAUNCHES - k2) == (12, 12)
    want_loss, _, want_g = loss_and_grads(plain, {"image": x, "label": y}, soft_target_ce)
    torch.testing.assert_close(loss, want_loss, rtol=1e-5, atol=0)
    for k, w in want_g.items():
        assert (grads[k] - w).norm().item() <= 1e-4 * w.norm().item() + 1e-12, k


def _set_swin_kernel(model, on):
    from cream_tpu_torch.nn.swin import SwinWindowAttention
    for m in model.modules():
        if isinstance(m, SwinWindowAttention):
            m.use_kernel = on


def test_native_codec_round_trip(tmp_path):
    """The sparse logits store's C++ codec, built from the checkout's source
    (g++, no card needed, so this runs on the CPU too): records written out
    of order through it read back as their fp16 values, class ids and
    seeds, through it and through numpy."""
    from cream_tpu_torch.distill import LogitsReader, LogitsWriter, native
    assert native.build().exists()
    rng = np.random.default_rng(3)
    N, K = 300, 100
    vals = rng.random((N, K)).astype(np.float32) / K
    idxs = rng.integers(0, 1000, (N, K)).astype(np.int32)
    seeds = rng.integers(0, 2 ** 31, N).astype(np.int32)
    w = LogitsWriter(str(tmp_path), 0, N, K, 1000)
    assert w.native
    order = rng.permutation(N)
    for i in range(0, N, 64):
        sel = order[i:i + 64]
        w.write_batch(sel, seeds[sel], vals[sel], idxs[sel])
    w.close()
    ask = rng.permutation(N)
    for use_native in (True, False):
        r = LogitsReader(str(tmp_path), 0, use_native=use_native)
        v, i, sd = r.read_batch(ask)
        r.close()
        np.testing.assert_array_equal(v, vals[ask].astype(np.float16).astype(np.float32))
        np.testing.assert_array_equal(i, idxs[ask])
        np.testing.assert_array_equal(sd, seeds[ask])


# ---- TinyCLIP's serving path: plain PyTorch (no TPU kernel lies on it), the
# card against the CPU ----

_CLIP_NARROW = dict(embed_dim=64, vision_width=128, vision_layers=2, vision_patch=16,
                    image_size=64, text_width=128, text_layers=2, text_heads=2,
                    context_length=16, vocab_size=1000)


def _narrow_clip_pair(card, kind, dtype, **ragged):
    """The narrow ViT ("vit") or RN ("rn") two-tower CLIP on seeded weights,
    fp32 on the CPU and `dtype` on the card."""
    from cream_tpu_torch.models.clip import CLIP, CLIPConfig
    from cream_tpu_torch.models.resnet import CLIPResNet

    def build(device, dt):
        if kind == "vit":
            return CLIP(CLIPConfig(**_CLIP_NARROW), dtype=dt, device=device, **ragged)
        return CLIPResNet((2, 1, 1, 1), 32, 8, 64, 16, 128, 2, 2, 16, 1000, dtype=dt,
                          device=device)

    cpu = build("cpu", torch.float32).eval()
    sd = seeded_state_dict(cpu, 0)
    cpu.load_state_dict(sd)
    gpu = build(card, dtype).eval()
    gpu.load_state_dict(sd)
    return cpu, gpu


def _clip_inputs(batch=4):
    rng = np.random.default_rng(1)
    images = torch.from_numpy(rng.standard_normal((batch, 64, 64, 3)).astype(np.float32))
    text = torch.from_numpy(rng.integers(1, 998, (batch, 16)))
    text[:, 0], text[torch.arange(batch), torch.arange(batch) + 5] = 998, 999
    return images, text


def _clip_gates(rng, width=128, layers=2, heads=2, mlp=512):
    g = {"hidden_z": rng.uniform(0.3, 1.5, width), "heads_z": rng.uniform(0.3, 1.5, (layers, heads)),
         "mha_z": rng.uniform(0.5, 1.5, layers), "intermediate_z": rng.uniform(0.3, 1.5, (layers, mlp)),
         "ffn_z": rng.uniform(0.5, 1.5, layers)}
    g["hidden_z"][: width // 4] = 0
    g["heads_z"][0, 0] = g["mha_z"][1] = g["ffn_z"][0] = 0
    g["intermediate_z"][:, : mlp // 3] = 0
    return {k: torch.from_numpy(v.astype(np.float32)) for k, v in g.items()}


def _run_clip(model, images, text, *gates):
    device = next(model.parameters()).device
    move = lambda g: None if g is None else {k: v.to(device) for k, v in g.items()}
    with torch.inference_mode():
        return [o.float().cpu() for o in model(images.to(device), text.to(device),
                                               *(move(g) for g in gates))]


@pytest.mark.parametrize("kind", ["vit", "rn"])
def test_narrow_clip_fp32_on_the_card_matches_the_cpu(card, kind):
    cpu, gpu = _narrow_clip_pair(card, kind, torch.float32)
    images, text = _clip_inputs()
    for got, want in zip(_run_clip(gpu, images, text), _run_clip(cpu, images, text)):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_gated_and_ragged_clip_on_the_card_match_the_cpu(card):
    rng = np.random.default_rng(2)
    vm, tm = _clip_gates(rng), _clip_gates(rng)
    images, text = _clip_inputs()
    cpu, gpu = _narrow_clip_pair(card, "vit", torch.float32)
    for got, want in zip(_run_clip(gpu, images, text, vm, tm),
                         _run_clip(cpu, images, text, vm, tm)):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    cpu, gpu = _narrow_clip_pair(card, "vit", torch.float32, vision_heads=(2, 0),
                                 vision_mlp_widths=(0, 300), text_heads_per_layer=(1, 2),
                                 text_mlp_widths=(256, 0))
    for got, want in zip(_run_clip(gpu, images, text), _run_clip(cpu, images, text)):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kind", ["vit", "rn"])
def test_narrow_clip_bf16_features_match_fp32_on_the_card(card, kind):
    _, gpu32 = _narrow_clip_pair(card, kind, torch.float32)
    _, gpu16 = _narrow_clip_pair(card, kind, torch.bfloat16)
    images, text = _clip_inputs()
    for got, want in zip(_run_clip(gpu16, images, text)[:2], _run_clip(gpu32, images, text)[:2]):
        assert float(torch.nn.functional.cosine_similarity(got, want, dim=-1).min()) >= 0.999


def test_pair_timing_runs_on_the_card_and_refuses_a_cpu_model(card):
    from cream_tpu_torch.cli.speed_test import pair_throughput
    cpu, gpu = _narrow_clip_pair(card, "vit", torch.bfloat16)
    with pytest.raises(RuntimeError, match="CUDA"):
        pair_throughput(cpu, 2)
    assert pair_throughput(gpu, 8, n_iters=2, warmup=1) > 0


# ---- TinyCLIP's training path: plain PyTorch, the card against the CPU ----

def _l0_trainer(device, dtype=torch.float32, remat=False):
    from cream_tpu_torch.cli.tinyclip_pipeline import L0Distill
    from cream_tpu_torch.models.clip import CLIP, CLIPConfig
    model = CLIP(CLIPConfig(**_CLIP_NARROW), dtype=dtype, device=device, remat=remat)
    model.load_state_dict(seeded_state_dict(model, 0))
    return L0Distill(model, lr=1e-3, l0_lr=0.1, target_sparsity=0.25, sparsity_warmup=2,
                     l0_init_mean=2.0)


def test_l0_distill_steps_on_the_card_match_the_cpu(card):
    """Two fp32 L0 distillation steps on the same uniforms: the losses and
    sparsities (1e-5), the multipliers (1e-5), the weights and gates within
    Adam's 2 * lr a step; the fuse on the card gives the CPU's state_dict
    shapes and its features (1e-5)."""
    from cream_tpu_torch.distill.l0 import named_l0
    from cream_tpu_torch.models.clip import prune_clip
    cpu, gpu = _l0_trainer("cpu"), _l0_trainer(card)
    images, text = _clip_inputs()
    rng = np.random.default_rng(3)
    for _ in range(2):
        uniforms = {k: {m: torch.from_numpy(rng.uniform(1e-6, 1 - 1e-6, tuple(t.shape))
                                            .astype(np.float32))
                        for m, t in zip(("hidden_z", "heads_z", "intermediate_z"),
                                        (p["hidden_loga"], p["heads_loga"],
                                         p["intermediate_loga"]))}
                    for k, p in cpu.l0.items()}
        lc, sc = cpu.step(images, text, uniforms=uniforms)
        lg, sg = gpu.step(images.to(card), text.to(card), uniforms={
            k: {m: u.to(card) for m, u in v.items()} for k, v in uniforms.items()})
        torch.testing.assert_close(lg.cpu(), lc, atol=0, rtol=1e-5)
        for k in sc:
            torch.testing.assert_close(sg[k].cpu(), sc[k], atol=1e-5, rtol=0)
    for (k, a), b in zip(named_l0(cpu.l0["v"]).items(), named_l0(gpu.l0["v"]).values()):
        tol = 1e-5 if k.startswith("lambda") else 2 * 0.1 * 2
        torch.testing.assert_close(b.detach().cpu(), a.detach(), atol=tol, rtol=0)
    for k, v in cpu.student.state_dict().items():
        torch.testing.assert_close(gpu.student.state_dict()[k].cpu(), v, atol=2 * 1e-3 * 2,
                                   rtol=0)
    masks = {k: {m: None if z is None else (tuple(r.cpu() for r in z) if isinstance(z, tuple)
                                            else z.cpu()) for m, z in g.items()}
             for k, g in gpu.masks().items()}
    sd = {k: v.cpu() for k, v in gpu.student.state_dict().items()}
    pc, _ = prune_clip(sd, gpu.student.cfg, masks["v"], masks["t"], device="cpu")
    pg, sdg = prune_clip(gpu.student.state_dict(), gpu.student.cfg, gpu.masks()["v"],
                         gpu.masks()["t"], device=card)
    assert {k: tuple(v.shape) for k, v in sdg.items()} == \
        {k: tuple(v.shape) for k, v in pc.state_dict().items()}
    for got, want in zip(_run_clip(pg, images, text), _run_clip(pc, images, text)):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_tinyclip_train_timing_on_the_card_with_and_without_remat(card):
    from cream_tpu_torch.cli.speed_test import tinyclip_train_throughput
    from cream_tpu_torch.models.clip import CLIP, CLIPConfig
    out = []
    for remat in (False, True):
        model = CLIP(CLIPConfig(**_CLIP_NARROW), dtype=torch.bfloat16, device=card,
                     remat=remat)
        model.load_state_dict(seeded_state_dict(model, 0))
        out.append(tinyclip_train_throughput(model, 8, n_iters=2, warmup=1))
    assert all(r["pairs_per_s"] > 0 for r in out)
    assert out[0]["first_loss"] == out[1]["first_loss"]


# ---- DeiT with iRPE and Mini-DeiT: plain PyTorch, the card against the CPU ----

def _narrow_irpe_model(kind, device, dtype=torch.float32):
    from cream_tpu_torch.models.deit_rpe import RPEVisionTransformer
    from cream_tpu_torch.models.mini_deit import MiniDeiT
    from cream_tpu_torch.ops.rpe import get_rpe_config
    kw = dict(num_classes=10, img_size=32, patch_size=8, embed_dim=64, num_heads=2,
              dtype=dtype, device=device)
    if kind == "mini":
        m = MiniDeiT(depth=4, **kw)
    else:
        m = RPEVisionTransformer(depth=2, distilled=kind == "distilled", rpe_config=get_rpe_config(
            1.9, "product", "ctx", True, 1, "qkv"), **kw)
    m.load_state_dict(seeded_state_dict(m, 5))
    return m


@pytest.mark.parametrize("transposed", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_irpe_at_deit_s_shape_on_the_card_matches_the_cpu(card, transposed, dtype):
    """IRPE at DeiT-S's shape (6 heads of 64, 197 tokens, 50 buckets; B=8),
    fp32 tables: the output within 1e-5 of the largest |out| in fp32 and 2
    bf16 ulps in bf16; the input's and the table's grads within 1e-5 (fp32)
    or 2% (bf16) of their largest magnitude: the gather's backward is a
    scatter-add, whose atomics sum in another order on the card."""
    from cream_tpu_torch.nn.rpe import IRPE
    from cream_tpu_torch.ops.rpe import get_rpe_config
    cfg = get_rpe_config(1.9, "product", "ctx", True, 1, "k").rpe_k
    rng = np.random.default_rng(0)
    shape = (8, 6, 197, 64) if transposed else (8, 6, 197, 197)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
    table = torch.from_numpy(rng.normal(0, 0.05, (1, 64, 50) if transposed else (1, 50, 64))
                             .astype(np.float32))
    outs = []
    for device in ("cpu", card):
        m = IRPE(64, 6, cfg, 14, 14, transposed=transposed, dtype=dtype, device=device)
        with torch.no_grad():
            m.lookup_table_weight.copy_(table)
        xi = x.to(device, copy=True).requires_grad_()
        y = m(xi)
        (y.float() * y.float()).sum().backward()
        outs.append([t.float().cpu() for t in (y, xi.grad, m.lookup_table_weight.grad)])
    for got, want in zip(outs[1], outs[0]):
        top = want.abs().max().item()
        lim = 1e-5 * top if dtype == torch.float32 else (
            2 * 2.0 ** (np.floor(np.log2(top)) - 7) if got is outs[1][0] else 2e-2 * top)
        assert (got - want).abs().max().item() <= lim


@pytest.mark.parametrize("kind", ["qkv", "distilled", "mini"])
def test_narrow_irpe_models_on_the_card_match_the_cpu(card, kind):
    """fp32 eval logits within 1e-5 of the CPU's; for DeiT iRPE-QKV and
    Mini-DeiT one train step's loss (1e-5) and grads (1e-4 of each tensor's
    largest grad, the gather's scatter-add summing with atomics, plus 1e-6
    of the largest grad of all: DeiT's last rpe_k table and k bias have
    grads at float noise); a distilled model's train-mode pair is refused
    by the plain step."""
    from cream_tpu_torch.train.losses import soft_target_ce
    from cream_tpu_torch.train.steps import loss_and_grads
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((4, 32, 32, 3)).astype(np.float32))
    y = torch.from_numpy(np.eye(10, dtype=np.float32)[rng.integers(0, 10, 4)])
    runs = []
    for device in ("cpu", card):
        m = _narrow_irpe_model(kind, device).eval()
        with torch.no_grad():
            logits = m(x.to(device)).cpu()
        if kind == "distilled":
            with pytest.raises(TypeError, match="tuple in train mode"):
                loss_and_grads(m, {"image": x.to(device), "label": y.to(device)}, soft_target_ce)
            runs.append((logits, None, {}))
            continue
        loss, _, grads = loss_and_grads(m, {"image": x.to(device), "label": y.to(device)},
                                        soft_target_ce)
        runs.append((logits, loss.cpu(), {k: g.cpu() for k, g in grads.items()}))
    (l_cpu, loss_cpu, g_cpu), (l_gpu, loss_gpu, g_gpu) = runs
    torch.testing.assert_close(l_gpu, l_cpu, atol=1e-5, rtol=1e-5)
    if kind != "distilled":
        torch.testing.assert_close(loss_gpu, loss_cpu, atol=0, rtol=1e-5)
        top = max(g.abs().max() for g in g_cpu.values())
        for k, want in g_cpu.items():
            assert (g_gpu[k] - want).abs().max() <= 1e-4 * want.abs().max() + 1e-6 * top, k


def test_mini_swin_capture_on_the_card(card):
    """Mini-Swin's distillation capture on the card: the logits bit for bit
    those without it, one qkv and one hidden state per executed layer."""
    from cream_tpu_torch.models.swin import MiniSwin
    m = MiniSwin(img_size=64, embed_dims=(32, 64, 64, 128), depths=(2, 2, 2, 2),
                 num_heads=(1, 2, 2, 4), num_classes=10, dtype=torch.bfloat16, device=card)
    m.load_state_dict(seeded_state_dict(m, 5))
    x = torch.randn(2, 64, 64, 3, device=card).bfloat16()
    with torch.inference_mode():
        plain = m.eval()(x)
        m.capture_distill = True
        logits, captures = m(x)
    assert torch.equal(logits, plain)
    assert len(captures["qkv_states"]) == len(captures["hidden"]) == 8
    assert captures["hidden"][0].shape == (2, 256, 32)


def _cream_supernet(card_or_cpu, dtype=torch.float32, route="library"):
    from cream_tpu_torch.models.cream import CreamSupernet
    from cream_tpu_torch.nn.layers import set_dw_kernel
    m = CreamSupernet(num_classes=10, stages=CREAM_STAGES, img_size=64, dtype=dtype,
                      device=card_or_cpu)
    m.load_state_dict(seeded_state_dict(m, 3))
    set_dw_kernel(m, route)
    return m


CREAM_PATH = [1, 0, 0, -1, 1, 1, 0, 5]   # a skip; k3 at most sites
CREAM_STAGES = ((16, 2, 2), (24, 2, 2), (32, 1, 2), (32, 1, 1), (48, 2, 2))


def test_cream_fused_step_matches_library(card):
    """One Cream supernet train step (KD against a teacher path; SGD at lr
    1, so the first update is the grad) on "fused" against "library" from
    the same weights: fp32 (TF32 off) loss 1e-5, grads 1e-4 of each
    tensor's largest plus 1e-6 of the largest of all (BN-cancelled grads
    sit at float noise); bf16 loss within 2 ulps; K7 and K9 launch at the
    paths' sites (the student's forward and backward, the teacher's
    forward), the library route none."""
    from cream_tpu_torch.nas import cream as nas
    from cream_tpu_torch.train.optim import make_sgd
    from cream_tpu_torch.train.state import TrainState
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((8, 64, 64, 3)).astype(np.float32)).to(card)
    y = torch.from_numpy(rng.integers(0, 10, 8)).to(card)
    teacher = [0, 1, 1, 0, 0, 1, 0, 1]
    (s1, s2), (t1, t2) = (dw3x3_path_sites(p, CREAM_STAGES) for p in (CREAM_PATH, teacher))
    want = {"k7_fwd": s1 + t1, "k7_bwd": s1, "k8": 0, "k9_fwd": s2 + t2, "k9_bwd": s2}
    assert want["k9_bwd"] == 4 and want["k7_bwd"] == 3
    for dtype in (torch.float32, torch.bfloat16):
        out = {}
        for route in ("library", "fused"):
            m = _cream_supernet(card, dtype, route)
            before = {n: p.detach().clone() for n, p in m.named_parameters()}
            state = TrainState(m, make_sgd(1.0, momentum=0.9))
            dwconv.reset_launches()
            loss = nas.make_cream_train_step()(
                state, {"image": x.to(dtype), "label": y}, CREAM_PATH, teacher, 0.5, True)[1]
            torch.cuda.synchronize()
            assert dwconv.LAUNCHES == (want if route == "fused" else
                                       {k: 0 for k in dwconv.LAUNCHES}), route
            out[route] = (float(loss["loss"]), {n: before[n] - p.detach()
                                                for n, p in m.named_parameters()})
        (l_ref, g_ref), (l_got, g_got) = out["library"], out["fused"]
        if dtype == torch.bfloat16:
            assert abs(l_got - l_ref) <= 2 * 2.0 ** (np.floor(np.log2(l_ref)) - 7)
            continue
        assert abs(l_got - l_ref) <= 1e-5 * l_ref
        top = max(g.abs().max().item() for g in g_ref.values())
        for k, g in g_ref.items():
            assert (g_got[k] - g).abs().max().item() <= 1e-4 * g.abs().max().item() \
                + 1e-6 * top, k


def test_narrow_nas_models_on_the_card_match_the_cpu(card):
    """fp32 logits of a narrow AutoFormer supernet (two configs) and the
    narrow Cream supernet on "fused" (K7/K9 at its sites) within 1e-5 of
    the CPU's."""
    from cream_tpu_torch.models.autoformer import AutoFormerSuper, SearchSpace, fixed_config
    sp = SearchSpace(mlp_ratio=(1.5, 2.0), num_heads=(1, 2), depth=(1, 2, 3),
                     embed_dim=(64, 96, 120))
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((2, 32, 32, 3)).astype(np.float32))
    outs = []
    for device in ("cpu", card):
        m = AutoFormerSuper(sp, num_classes=10, img_size=32, patch_size=8, device=device)
        m.load_state_dict(seeded_state_dict(m, 5))
        with torch.no_grad():
            outs.append([m.eval()(x.to(device), config=fixed_config(sp, s)).cpu()
                         for s in ("smallest", "seed:3")])
    for a, b in zip(*outs):
        torch.testing.assert_close(b, a, atol=1e-5, rtol=1e-5)
    x = torch.from_numpy(rng.standard_normal((2, 64, 64, 3)).astype(np.float32))
    got = []
    for device, route in (("cpu", "library"), (card, "fused")):
        with torch.no_grad():
            got.append(_cream_supernet(device, route=route).eval()(
                x.to(device), config=CREAM_PATH).cpu())
    torch.testing.assert_close(got[1], got[0], atol=1e-5, rtol=1e-5)


# DARTS' depthwise 3x3 sites: the search network's at its step's 32x32 maps
# and the CDARTS retrain network's at 224 (smaller batches than the smoke's)
DARTS_SITES = [(32, 32, 16, 1), (32, 32, 32, 2), (16, 16, 32, 1), (16, 16, 64, 2), (8, 8, 64, 1),
               (28, 28, 48, 1), (28, 28, 96, 2), (14, 14, 96, 1), (14, 14, 192, 2), (7, 7, 192, 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,W,C,stride", DARTS_SITES)
def test_dw_kernels_at_darts_sites(card, dtype, H, W, C, stride):
    _check_dw_kernels(card, dtype, 8, H, W, C, stride)


@pytest.mark.parametrize("H,W,C,stride", DARTS_SITES)
def test_darts_sep_conv_fused_matches_library(card, H, W, C, stride):
    """A 3x3 SepConv (train mode, fp32, TF32 off) on "fused" against
    "library" from the same weights, under a fixed random projection of its
    output (a loss like sum(y²) is flat in the input through a train-mode
    BN, leaving grads of rounding noise): the output within 1e-5 and the
    grads of the input and every param within 1e-4 of their largest
    |value|; two K7 (or K9 then K7) launches forward and two backward."""
    from cream_tpu_torch.models.darts import SepConv
    from cream_tpu_torch.nn.layers import set_dw_kernel
    rng = np.random.default_rng(H * C + stride)
    x = torch.from_numpy(rng.standard_normal((8, H, W, C)).astype(np.float32)).to(card)
    r = torch.from_numpy(rng.standard_normal((8, (H - 1) // stride + 1, (W - 1) // stride + 1,
                                              C)).astype(np.float32)).to(card)
    outs = {}
    for route in ("library", "fused"):
        m = SepConv(C, 3, stride, device=card).train()
        m.load_state_dict(seeded_state_dict(m, 1))
        set_dw_kernel(m, route)
        xi = x.clone().requires_grad_()
        dwconv.reset_launches()
        y = m(xi)
        grads = torch.autograd.grad((y * r).sum(), [xi] + list(m.parameters()))
        torch.cuda.synchronize()
        outs[route] = (y.detach(), grads, dict(dwconv.LAUNCHES))
    (y0, g0, n0), (y1, g1, n1) = outs["library"], outs["fused"]
    want = ({"k7_fwd": 2, "k7_bwd": 2, "k8": 0, "k9_fwd": 0, "k9_bwd": 0} if stride == 1 else
            {"k7_fwd": 1, "k7_bwd": 1, "k8": 0, "k9_fwd": 1, "k9_bwd": 1})
    assert n1 == want and sum(n0.values()) == 0
    assert (y1 - y0).abs().max().item() <= 1e-5 * max(1.0, y0.abs().max().item())
    for a, b in zip(g1, g0):
        assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item()


def test_darts_search_steps_launch_at_their_sites_on_the_card(card):
    """A narrow DARTS search network (C 8, 3 layers, 3 nodes; bs8 32x32):
    the weight step and the alpha step on "fused" launch K7/K9 as
    `dw3x3_step_launches` says; the fp32 logits and alpha grads on "fused"
    on the card within 1e-3 of their largest |value| of the CPU's library
    route (the CPU's fp32 alpha grads of the full-width network sit 1.4e-4
    off a float64 run)."""
    from cream_tpu_torch.models.darts import SearchCNN, dw3x3_step_launches
    from cream_tpu_torch.nas.cdarts import make_alpha_adam, make_alpha_step, make_weight_step
    from cream_tpu_torch.nn.layers import set_dw_kernel
    from cream_tpu_torch.train.optim import make_sgd
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((8, 32, 32, 3)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 10, 8))
    a = {k: torch.from_numpy((rng.standard_normal((9, 8))).astype(np.float32))
         for k in ("normal", "reduce")}
    got = {}
    for device, route in (("cpu", "library"), (card, "fused")):
        m = SearchCNN(C=8, n_layers=3, n_nodes=3, device=device)
        m.load_state_dict(seeded_state_dict(m, 2))
        set_dw_kernel(m, route)
        ad = {k: v.detach().to(device).requires_grad_() for k, v in a.items()}
        logits = m.eval()(x.to(device), ad["normal"], ad["reduce"])
        torch.nn.functional.cross_entropy(logits, y.to(device)).backward()
        got[route] = [logits.detach().cpu()] + [ad[k].grad.cpu() for k in ("normal", "reduce")]
        if route == "fused":
            alphas = {k: v.detach().clone().to(device) for k, v in a.items()}
            batch = {"image": x.to(device), "label": y.to(device)}
            for step, alpha in ((make_weight_step(m, make_sgd(0.05)), False),
                                (make_alpha_step(m, make_alpha_adam()), True)):
                dwconv.reset_launches()
                step(alphas, batch)
                torch.cuda.synchronize()
                assert dwconv.LAUNCHES == dw3x3_step_launches(m, alpha), alpha
    for p, q in zip(got["fused"], got["library"]):
        assert (p - q).abs().max().item() <= 1e-3 * q.abs().max().item()


def test_narrow_darts_networks_on_the_card_match_the_cpu(card):
    """fp32 logits of a narrow CDARTS retrain network on "fused", a narrow
    NAS-Bench-201 infer network and a narrow CDARTS controller's nas and
    super paths on the card within 1e-5 (relative) of the CPU's."""
    from cream_tpu_torch.models.darts import EXAMPLE_GENOTYPE, CDARTSRetrain
    from cream_tpu_torch.models.nasbench201 import EXAMPLE_ARCH, TinyNetwork201Infer
    from cream_tpu_torch.nas.cdarts_stage import CDARTSController, init_stage_alphas
    from cream_tpu_torch.nn.layers import set_dw_kernel
    rng = np.random.default_rng(6)
    x64 = torch.from_numpy(rng.standard_normal((2, 64, 64, 3)).astype(np.float32))
    x32 = x64[:, :32, :32].contiguous()
    alphas = init_stage_alphas(torch.Generator().manual_seed(3), 4)
    outs = []
    for device, route in (("cpu", "library"), (card, "fused")):
        r = CDARTSRetrain([EXAMPLE_GENOTYPE] * 3, init_channels=8, num_classes=10, device=device)
        n = TinyNetwork201Infer(EXAMPLE_ARCH, C=8, N=2, device=device)
        c = CDARTSController([EXAMPLE_GENOTYPE] * 2, layer_num=2, cells_per_layer=1, n_nodes=4,
                             C=4, aux_pool_size=4, device=device)
        a = {k: v.to(device) for k, v in alphas.items()}
        out = []
        for m, x, kw in ((r, x64, None), (n, x32, None), (c, x32, dict(super_flag=False)),
                         (c, x32, dict(layer_idx=1))):
            m.load_state_dict(seeded_state_dict(m, 4))
            set_dw_kernel(m, route)
            with torch.no_grad():
                o = m.eval()(x.to(device)) if kw is None else m.eval()(x.to(device), a, **kw)
            out += [t.cpu() for t in (o if isinstance(o, tuple) else (o,))]
        outs.append(out)
    for p, q in zip(outs[1], outs[0]):
        assert (p - q).abs().max().item() <= 1e-5 * max(1.0, q.abs().max().item())


@pytest.mark.parametrize("kernel,stride,pad,include", [(3, 1, 1, False), (3, 2, 1, False),
                                                       (3, 1, 1, True), (2, 2, 0, True),
                                                       (6, 2, 0, False)])
def test_darts_avg_pool_grads_on_the_card_match_the_cpu(card, kernel, stride, pad, include):
    """`models.darts.avg_pool` (DARTS' and NAS-Bench-201's 3x3 pools, the
    201 ResNet block's 2x2 and the aux head's 6x6) on an NHWC map: float64
    output and input grad on the card equal the CPU's to 1e-12 of their
    largest (torch's own `avg_pool2d` backward on a channels_last input is
    wrong on the card, which is why the helper pools a contiguous copy)."""
    from cream_tpu_torch.models.darts import avg_pool
    x = torch.randn(4, 16, 16, 24, dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    out = []
    for device in ("cpu", card):
        xi = x.to(device).requires_grad_()
        y = avg_pool(xi, kernel, stride, pad, include)
        gy = torch.linspace(-1, 1, y.numel(), dtype=y.dtype, device=device).reshape(y.shape)
        gx, = torch.autograd.grad((y * gy).sum(), [xi])
        out.append((y.detach().cpu(), gx.cpu()))
    for a, b in zip(out[1], out[0]):
        assert (a - b).abs().max().item() <= 1e-12 * b.abs().max().item()


# the detectors' attention windows: EfficientViT-M4 at canvas 512 (7x7 over
# a 32x32 map, 25 windows an image; 7x7 over 16x16, 9; 4x4 over 8x8, 4)
# and at 128 (4x4 over 4x4; 2x2 over 2x2)
M4_KERNELS = _CONFIGS["efficientvit_m4"]["kernels"]
DET_CGA = [("m4_512_s0", 7, 128, 4, 25), ("m4_512_s1", 7, 256, 4, 9),
           ("m4_512_s2", 4, 384, 4, 4), ("m4_128_s1", 4, 256, 4, 1), ("m4_128_s2", 2, 384, 4, 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,ws,C,heads,per_image", DET_CGA)
def test_k4_matches_plain_at_detector_windows(card, dtype, name, ws, C, heads, per_image):
    """K4 against its plain version at a detector's stage shape, 2 images'
    windows, zero-padded windows included (stage 0's 32x32 map in 7x7
    windows): 8 bf16 ulps at the largest |out|, fp32 1e-5."""
    from cream_tpu_torch.ops.window import window_partition
    m = _seeded_cga(C, heads, ws, M4_KERNELS, card, dtype)
    g = torch.Generator(card).manual_seed(C + ws)
    side = {25: 32, 9: 16, 4: 8, 1: ws}[per_image]
    fmap = torch.randn(2, side, side, C, generator=g, device=card).to(dtype)
    x, _ = window_partition(fmap, ws)
    x = x.reshape(-1, ws, ws, C).contiguous()
    assert x.shape[0] == 2 * per_image
    kw = dict(ws=ws, heads=heads, c_in=C // heads, kd=16, d=C // heads, ks_max=m.ks_max)
    ops = cga.fold_cga_variables(m, dtype)
    before = cga.LAUNCHES
    with torch.inference_mode():
        got = cga.fused_cga(x, m.attention_biases, m.attention_bias_idxs, *ops, **kw)
        torch.cuda.synchronize()
        want = cga.fused_cga_ref(x, m.attention_biases, m.attention_bias_idxs, *ops, **kw)
    assert cga.LAUNCHES == before + 1
    err = (got.float() - want.float()).abs().max().item()
    assert err <= _cga_bound(dtype, want.float(), 8), err


def _bf16_ulps(got, want, ulps):
    top = max(1.0, want.float().abs().max().item())
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
    return (got.float() - want.float()).abs().max().item() <= ulps * ulp


@pytest.mark.parametrize("name", ["retinanet_efficientvit_m4", "mask_rcnn_efficientvit_m4"])
def test_detector_cascade_matches_plain_bf16(card, name):
    """bf16 at canvas 512, B=2: the detector's outputs (RetinaNet's cls and
    deltas; Mask R-CNN's five FPN levels and its RPN outputs) on the
    "cascade" route within 8 bf16 ulps of the "plain" route's at the
    largest |out|; 6 K4 launches a forward."""
    from cream_tpu_torch.models import create_model
    m = create_model(name, device=card, dtype=torch.bfloat16)
    m.load_state_dict(seeded_state_dict(m, 0))
    x = torch.randn(2, 512, 512, 3, generator=torch.Generator(card).manual_seed(1),
                    device=card).to(torch.bfloat16)
    outs = {}
    for route in ("cascade", "plain"):
        m.backbone.set_attn_kernel(route)
        before = cga.LAUNCHES
        with torch.inference_mode():
            out = m(x)
        assert cga.LAUNCHES - before == (6 if route == "cascade" else 0), route
        outs[route] = [t for o in out for t in (o if isinstance(o, tuple) else (o,))]
    for got, want in zip(outs["cascade"], outs["plain"]):
        assert bool(torch.isfinite(got).all())
        assert _bf16_ulps(got, want, 8)


def test_detector_fused_train_step_launches_every_site(card):
    """A RetinaNet-M4 bf16 train step at canvas 256 on "fused": K7 and K9
    forward and backward at every site `models.retinanet.dw3x3_sites`
    counts, none refused; its loss within 2 bf16 ulps of "library"'s."""
    from cream_tpu_torch.cli.speed_test import detector_train_step_fn
    from cream_tpu_torch.models import create_model
    from cream_tpu_torch.models.retinanet import dw3x3_step_launches
    from cream_tpu_torch.nn.layers import DW_REFUSED, set_dw_kernel
    losses = {}
    for route in ("library", "fused"):
        m = create_model("retinanet_efficientvit_m4", canvas=256, num_classes=10, device=card,
                         dtype=torch.bfloat16)
        m.load_state_dict(seeded_state_dict(m, 0))
        set_dw_kernel(m, route)
        _, run = detector_train_step_fn(m, 2)
        DW_REFUSED.clear()
        dwconv.reset_launches()
        loss, _ = run()
        torch.cuda.synchronize()
        want = dw3x3_step_launches(m, 2) if route == "fused" else dict.fromkeys(dwconv.LAUNCHES, 0)
        assert dwconv.LAUNCHES == want, route
        assert not DW_REFUSED
        losses[route] = float(loss)
    assert abs(losses["fused"] - losses["library"]) <= 2 * 2.0 ** (np.floor(np.log2(
        abs(losses["library"]))) - 7)


def test_clip_rn_tower_block_input_grad_on_the_card_matches_the_cpu(card):
    """A CLIP RN50 tower block that avg-pools (layer2's first, stride 2) and
    the stem's pool: fp32 output and input grad on the card within 1e-5 of
    the CPU's at their largest (the pool runs on a contiguous NCHW copy;
    on a channels_last input torch's CUDA backward is wrong)."""
    from cream_tpu_torch.models.resnet import CLIPBottleneck, _avg_pool
    blk = CLIPBottleneck(256, 128, 2, dtype=torch.float32)
    blk.load_state_dict(seeded_state_dict(blk, 0))
    x = torch.randn(2, 28, 28, 256, generator=torch.Generator().manual_seed(1))
    out = []
    for device in ("cpu", card):
        blk.to(device)
        xi = x.to(device).requires_grad_()
        y = blk(_avg_pool(xi, 1))
        gy = torch.linspace(-1, 1, y.numel(), device=device).reshape(y.shape)
        g, = torch.autograd.grad((y * gy).sum(), [xi])
        out.append((y.detach().cpu(), g.cpu()))
    for a, b in zip(out[1], out[0]):
        assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item()


def test_narrow_detr_on_the_card_matches_the_cpu(card):
    """A narrow DETR with iRPE on q, k and v on a padded batch: fp32
    outputs on the card within 1e-5 of the CPU's, the per-grid tables made
    on the card."""
    from cream_tpu_torch.models.detr import DETR, parse_enc_rpe2d
    from cream_tpu_torch.models.resnet import ResNetBackbone
    m = DETR(ResNetBackbone((1, 1, 1, 1), "basic"), num_classes=5, num_queries=8,
             hidden_dim=32, nhead=4, num_encoder_layers=2, num_decoder_layers=2,
             dim_feedforward=64, aux_loss=True,
             rpe_config=parse_enc_rpe2d("rpe-1.9-product-ctx-1-qkv")).eval()
    m.load_state_dict(seeded_state_dict(m, 0))
    x = torch.randn(2, 100, 130, 3, generator=torch.Generator().manual_seed(1))
    mask = torch.zeros(2, 100, 130, dtype=torch.bool)
    mask[0, 81:] = True
    outs = []
    for device in ("cpu", card):
        m.to(device)
        with torch.no_grad():
            o = m(x.to(device), mask.to(device))
        outs.append([o[k].cpu() for k in ("pred_logits", "pred_boxes")])
    for a, b in zip(outs[1], outs[0]):
        assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item()


def test_cydas_fused_step_launches_every_site(card):
    """A cydas_seg bf16 train step at an odd 97 x 129 crop on "fused": K7
    forward and backward at the six stride-1 depthwise sites, no K9, none
    refused; the loss within 2 bf16 ulps of "library"'s."""
    from cream_tpu_torch.cli.speed_test import seg_train_step_fn
    from cream_tpu_torch.models import create_model
    from cream_tpu_torch.models.cydas_seg import dw3x3_sites
    from cream_tpu_torch.nn.layers import DW_REFUSED, set_dw_kernel
    losses = {}
    for route in ("library", "fused"):
        m = create_model("cydas_seg", device=card, dtype=torch.bfloat16)
        m.load_state_dict(seeded_state_dict(m, 0))
        set_dw_kernel(m, route)
        _, run = seg_train_step_fn(m, 2, (97, 129))
        DW_REFUSED.clear()
        dwconv.reset_launches()
        loss, _ = run()
        torch.cuda.synchronize()
        n = len(dw3x3_sites(2, 97, 129)) if route == "fused" else 0
        assert dwconv.LAUNCHES == {"k7_fwd": n, "k7_bwd": n, "k8": 0, "k9_fwd": 0,
                                   "k9_bwd": 0}, route
        assert not DW_REFUSED
        losses[route] = float(loss)
    assert abs(losses["fused"] - losses["library"]) <= 2 * 2.0 ** (np.floor(np.log2(
        abs(losses["library"]))) - 7)


# ---- the data-parallel global BatchNorm's per-rank passes ----

@pytest.mark.parametrize("shape,channels_last,dtype,affine", [
    ((8, 96, 14, 14), True, torch.bfloat16, True), ((4, 32, 7, 9), True, torch.float32, True),
    ((6, 24, 5, 5), False, torch.float32, False), ((16, 48), False, torch.float32, True)])
def test_global_batch_norm_passes_match_the_cpu(card, shape, channels_last, dtype, affine):
    """`nn.layers`' GlobalBatchNorm passes on a CUDA tensor (batch_norm_stats
    -> sums, batch_norm_elemt, batch_norm_backward_reduce / _elemt) against
    the same passes written out in fp32 on the CPU: sums 1e-5 of their
    largest, y and dx within 1 ulp of the dtype (2 for bf16), the weight
    and bias grads 1e-5 of their largest."""
    from cream_tpu_torch.nn import layers as L
    g = torch.Generator().manual_seed(0)
    y = (torch.randn(shape, generator=g) * 2 + 0.5).to(dtype)
    dy = torch.randn(shape, generator=g).to(dtype)
    C = shape[1]
    w = torch.rand(C, generator=g) + 0.5 if affine else None
    b = torch.randn(C, generator=g) if affine else None
    if channels_last:
        y, dy = (t.to(memory_format=torch.channels_last) for t in (y, dy))
    n = y.numel() // C
    out = {}
    for dev in ("cpu", "cuda"):
        yd, dyd = y.to(dev), dy.to(dev)
        wd = None if w is None else w.to(dev)
        bd = None if b is None else b.to(dev)
        sums = L._local_sums(yd)
        mean = sums[:C] / n
        invstd = torch.rsqrt((sums[C:] / n - mean * mean).clamp_min(0) + 1e-5)
        fwd = L._normalize(yd, wd, bd, mean, invstd, 1e-5)
        s_dy, s_xmu, dw, db = L._backward_reduce(dyd, yd, wd, mean, invstd, affine)
        dx = L._backward_elemt(dyd, yd, wd, mean, invstd, s_dy, s_xmu,
                               torch.tensor(float(n), device=dev))
        out[dev] = [t if t is None else t.float().cpu()
                    for t in (sums, fwd, s_dy, s_xmu, dw, db, dx)]
    cpu, gpu = out["cpu"], out["cuda"]
    ulps = (2 if dtype == torch.bfloat16 else 1) * (2.0 ** -7 if dtype == torch.bfloat16
                                                   else 2.0 ** -23)
    for i in (0, 2, 3, 4, 5):
        if cpu[i] is None:
            assert gpu[i] is None
            continue
        torch.testing.assert_close(gpu[i], cpu[i], rtol=0,
                                   atol=1e-5 * float(cpu[i].abs().max()) + 1e-6)
    for i in (1, 6):
        lim = ulps * cpu[i].abs().clamp_min(2.0 ** -6) + 1e-5 * float(cpu[i].abs().max())
        assert bool(((gpu[i] - cpu[i]).abs() <= lim).all()), i


@pytest.mark.parametrize("shape,channels_last,dtype", [
    ((8, 96, 14, 14), True, torch.bfloat16), ((4, 32, 7, 9), True, torch.float32),
    ((6, 5, 4, 24), False, torch.float32)])
def test_bn_train_norm_matches_the_cpu(card, shape, channels_last, dtype):
    """`ops.bn.bn_train_norm` (the gated train-mode BN, its backward folded
    into dx) on the card against the CPU: y and dx within 1 ulp of the
    dtype (2 for bf16) plus 1e-5 of their largest, the moments and the
    scale and bias grads 1e-5 of their largest. An NCHW view with
    channels_last strides normalizes over dim 1, an NHWC tensor over -1."""
    from cream_tpu_torch.ops import bn
    g = torch.Generator().manual_seed(1)
    x = (torch.randn(shape, generator=g) * 2 + 0.5).to(dtype)
    dy = torch.randn(shape, generator=g).to(dtype)
    cdim = 1 if channels_last else -1
    if channels_last:
        x, dy = (t.to(memory_format=torch.channels_last) for t in (x, dy))
    C = x.shape[cdim]
    scale, bias = torch.rand(C, generator=g) + 0.5, torch.randn(C, generator=g)
    out = {}
    for dev in ("cpu", "cuda"):
        xd = x.to(dev).requires_grad_()
        sd, bd = scale.to(dev).requires_grad_(), bias.to(dev).requires_grad_()
        mu, var = bn._moments(xd, cdim)
        y = bn.bn_train_norm(xd, mu, var, sd, bd, 1e-5, channel_dim=cdim)
        assert y.dtype == dtype and y.stride() == xd.stride()
        dx, ds, db = torch.autograd.grad(y, (xd, sd, bd), dy.to(dev))
        out[dev] = [t.detach().float().cpu() for t in (mu, var, ds, db, y, dx)]
    ulps = 2 * 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -23
    for i, (gpu, cpu) in enumerate(zip(out["cuda"], out["cpu"])):
        if i < 4:
            torch.testing.assert_close(gpu, cpu, rtol=0,
                                       atol=1e-5 * float(cpu.abs().max()) + 1e-6)
        else:
            lim = ulps * cpu.abs().clamp_min(2.0 ** -6) + 1e-5 * float(cpu.abs().max())
            assert bool(((gpu - cpu).abs() <= lim).all()), i
