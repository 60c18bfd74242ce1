"""cream_tpu_torch window attention vs the JAX package's fused kernel.

The JAX side runs its Pallas kernel in interpret mode on the CPU; the port's
side is `window_attention_ref`, the plain version its CUDA kernel is held to
on the card. Inputs come from one numpy seed and are fed to both.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cream_tpu.ops.pallas.window_attention import \
    fused_window_attention as jax_fused_window_attention
from cream_tpu_torch.ops import window_attention as wa
from torch_threads import one_torch_thread_module  # noqa: F401


def _shift_mask(H, W, ws, shift):
    """Swin's shifted-window additive mask, (nH*nW, N, N) with 0 / -100."""
    img = np.zeros((H, W), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    win = img.reshape(H // ws, ws, W // ws, ws).transpose(0, 2, 1, 3)
    win = win.reshape(-1, ws * ws)
    return np.where(win[:, None, :] != win[:, :, None], -100.0, 0.0).astype(np.float32)


CASES = [
    # B, H, W, ws, heads, kd, dv, layout, mask, qkv_bias
    (2, 14, 14, 7, 6, 32, 32, "head_major", False, True),    # JAX packs 2 windows
    (1, 14, 14, 14, 4, 32, 32, "head_major", False, True),   # one 196-token window
    (2, 14, 14, 7, 4, 16, 16, "qkv_major", True, False),     # Swin packing + shift mask
    (1, 14, 21, 7, 3, 16, 32, "head_major", False, True),    # kd != dv, rectangular
    (1, 12, 24, 12, 2, 32, 32, "head_major", False, True),   # 144 tokens (TinyViT-384)
]


@pytest.mark.parametrize("B,H,W,ws,heads,kd,dv,layout,use_mask,use_qb", CASES)
def test_ref_matches_jax_kernel(B, H, W, ws, heads, kd, dv, layout, use_mask,
                                use_qb):
    rng = np.random.default_rng(0)
    L, N = heads * (2 * kd + dv), ws * ws
    qkv = rng.standard_normal((B, H, W, L)).astype(np.float32)
    bias = (rng.standard_normal((heads, N, N)) * 0.5).astype(np.float32)
    mask = _shift_mask(H, W, ws, ws // 2) if use_mask else None
    qb = (rng.standard_normal(L) * 0.1).astype(np.float32) if use_qb else None
    kw = dict(window=ws, heads=heads, kd=kd, dv=dv, layout=layout)

    want = jax_fused_window_attention(
        jnp.asarray(qkv), jnp.asarray(bias),
        None if mask is None else jnp.asarray(mask),
        qkv_bias=None if qb is None else jnp.asarray(qb), interpret=True, **kw)
    t = lambda a: None if a is None else torch.from_numpy(a)
    got = wa.window_attention_ref(t(qkv), t(bias), t(mask), qkv_bias=t(qb), **kw)
    # fp32 on both sides; sums in another order: the Pallas tests' tolerance
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)


def test_wrapper_takes_plain_version_on_cpu():
    rng = np.random.default_rng(1)
    qkv = torch.from_numpy(rng.standard_normal((2, 14, 14, 6 * 96)).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal((6, 49, 49)).astype(np.float32))
    qb = torch.from_numpy(rng.standard_normal(6 * 96).astype(np.float32))
    kw = dict(window=7, heads=6, kd=32, dv=32, qkv_bias=qb)
    before = wa.LAUNCHES
    got = wa.fused_window_attention(qkv, bias, **kw)
    # same function on the same inputs: bit-identical, and no kernel launch
    assert torch.equal(got, wa.window_attention_ref(qkv, bias, **kw))
    assert wa.LAUNCHES == before


def test_bf16_plain_version_rounds_like_jax():
    """bf16 qkv: P is rounded to bf16 before P.V on both sides."""
    rng = np.random.default_rng(2)
    qkv = rng.standard_normal((2, 14, 14, 6 * 96)).astype(np.float32)
    bias = rng.standard_normal((6, 49, 49)).astype(np.float32)
    want = jax_fused_window_attention(jnp.asarray(qkv, jnp.bfloat16),
                                      jnp.asarray(bias), window=7, heads=6,
                                      kd=32, dv=32, interpret=True)
    got = wa.window_attention_ref(torch.from_numpy(qkv).bfloat16(),
                                  torch.from_numpy(bias), window=7, heads=6,
                                  kd=32, dv=32)
    assert got.dtype == torch.bfloat16
    # outputs |o| < 4 in bf16: one ulp is at most 2^-6; allow one ulp either side
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2 ** -5, rtol=0)


@pytest.mark.parametrize("H,W,ws,heads", [
    (14, 13, 7, 2),     # W not a multiple of the window
    (12, 14, 7, 2),     # H not a multiple of the window
    (17, 17, 17, 1),    # 289 tokens > 256
])
def test_wrapper_rejects_shapes(H, W, ws, heads):
    qkv = torch.zeros(1, H, W, heads * 96)
    bias = torch.zeros(heads, ws * ws, ws * ws)
    with pytest.raises(ValueError):
        wa.fused_window_attention(qkv, bias, window=ws, heads=heads, kd=32, dv=32)


def test_wrapper_rejects_bad_operands():
    qkv = torch.zeros(1, 14, 14, 2 * 96)
    with pytest.raises(ValueError):         # bias of the wrong shape
        wa.fused_window_attention(qkv, torch.zeros(2, 49, 48), window=7,
                                  heads=2, kd=32, dv=32)
    with pytest.raises(ValueError):         # L != heads*(2kd+dv)
        wa.fused_window_attention(qkv, torch.zeros(2, 49, 49), window=7,
                                  heads=2, kd=32, dv=16)
    with pytest.raises(ValueError):         # unknown lane packing
        wa.fused_window_attention(qkv, torch.zeros(2, 49, 49), window=7,
                                  heads=2, kd=32, dv=32, layout="other")


def _emulate_k1_bf16(qkv, bias, mask, qb, *, window, heads, kd, dv, layout):
    """The bf16 K1 kernel's arithmetic, in torch: q/k/v bias-folded and
    rounded to bf16; S = Q.K^T with fp32 sums (the mma accumulator); the
    score (S * scale) + bias (+ mask), each operation rounded on its own;
    softmax with the exact row max; P = e / sum in fp32, then rounded to bf16
    (normalise, then round); P.V with fp32 sums, stored in bf16."""
    from cream_tpu_torch.ops.window import window_partition, window_reverse
    B, H, W, _ = qkv.shape
    x = qkv if qb is None else qkv + qb.to(qkv.dtype)
    w, padded = window_partition(x, window)
    q, k, v = (t.float() for t in wa.split_qkv(w, layout, heads, kd, dv))
    s = torch.einsum("bnhk,bmhk->bhnm", q, k) * (kd ** -0.5) + bias[None]
    if mask is not None:
        nwin = mask.shape[0]
        s = s.unflatten(0, (-1, nwin)) + mask[None, :, None]
        s = s.flatten(0, 1)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = (e / e.sum(-1, keepdim=True)).bfloat16().float()
    o = torch.einsum("bhnm,bmhd->bnhd", p, v).bfloat16()
    return window_reverse(o.flatten(-2), window, padded, (H, W))


@pytest.mark.parametrize("B,H,W,ws,heads,kd,dv,layout,use_mask,use_qb", CASES)
def test_k1_bf16_numerics_match_jax_kernel(B, H, W, ws, heads, kd, dv, layout,
                                           use_mask, use_qb):
    """The tensor-core K1's rounding points (normalise P in fp32, then round
    it to bf16; fp32 sums) against the JAX kernel in bf16, within two ulps
    at the largest |out|, the bound the card holds K1 to."""
    rng = np.random.default_rng(3)
    L, N = heads * (2 * kd + dv), ws * ws
    qkv = rng.standard_normal((B, H, W, L)).astype(np.float32)
    bias = (rng.standard_normal((heads, N, N)) * 0.5).astype(np.float32)
    mask = _shift_mask(H, W, ws, ws // 2) if use_mask else None
    qb = (rng.standard_normal(L) * 0.1).astype(np.float32) if use_qb else None
    kw = dict(window=ws, heads=heads, kd=kd, dv=dv, layout=layout)
    want = np.asarray(jax_fused_window_attention(
        jnp.asarray(qkv, jnp.bfloat16), jnp.asarray(bias),
        None if mask is None else jnp.asarray(mask),
        qkv_bias=None if qb is None else jnp.asarray(qb), interpret=True, **kw), np.float32)
    t = lambda a: None if a is None else torch.from_numpy(a)
    got = _emulate_k1_bf16(t(qkv).bfloat16(), t(bias), t(mask), t(qb), **kw)
    assert got.dtype == torch.bfloat16
    top = max(1.0, np.abs(want).max())
    two_ulps = 2.0 ** (np.floor(np.log2(top)) - 6)
    np.testing.assert_allclose(got.float().numpy(), want, atol=two_ulps, rtol=0)
    # and the plain version, which the card holds the kernel to, agrees too
    ref = wa.window_attention_ref(t(qkv).bfloat16(), t(bias), t(mask), qkv_bias=t(qb), **kw)
    np.testing.assert_allclose(got.float().numpy(), ref.float().numpy(), atol=two_ulps, rtol=0)

