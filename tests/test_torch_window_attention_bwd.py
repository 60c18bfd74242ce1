"""cream_tpu_torch's window-attention backward (K2's plain version and the
K1+K2 autograd.Function) vs the JAX package's fused kernel.

The JAX side is `jax.vjp` of its `fused_window_attention` with the Pallas
kernels in interpret mode, so its custom_vjp runs `_bwd_kernel` on the CPU.
Inputs and the cotangent come from one numpy seed and are fed to both.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cream_tpu.ops.pallas.window_attention import \
    fused_window_attention as jax_fused_window_attention
from cream_tpu_torch.ops import window_attention as wa
from cream_tpu_torch.ops.window import window_partition, window_reverse
from test_torch_window_attention import CASES, _shift_mask
from torch_threads import one_torch_thread_module  # noqa: F401


def _inputs(seed, B, H, W, ws, heads, kd, dv, use_mask, use_qb):
    rng = np.random.default_rng(seed)
    L, N = heads * (2 * kd + dv), ws * ws
    qkv = rng.standard_normal((B, H, W, L)).astype(np.float32)
    bias = (rng.standard_normal((heads, N, N)) * 0.5).astype(np.float32)
    mask = _shift_mask(H, W, ws, ws // 2) if use_mask else None
    qb = (rng.standard_normal(L) * 0.1).astype(np.float32) if use_qb else None
    dout = rng.standard_normal((B, H, W, heads * dv)).astype(np.float32)
    return qkv, bias, mask, qb, dout


def _jax_grads(qkv, bias, mask, qb, dout, dtype, **kw):
    """(dqkv, dbias, d(qkv_bias) or None) of the JAX kernel pair."""
    m = None if mask is None else jnp.asarray(mask)
    if qb is None:
        f = lambda q, b: jax_fused_window_attention(q, b, m, interpret=True, **kw)
        args = (jnp.asarray(qkv, dtype), jnp.asarray(bias))
    else:
        f = lambda q, b, c: jax_fused_window_attention(q, b, m, qkv_bias=c,
                                                       interpret=True, **kw)
        args = (jnp.asarray(qkv, dtype), jnp.asarray(bias), jnp.asarray(qb))
    _, vjp = jax.vjp(f, *args)
    grads = vjp(jnp.asarray(dout, dtype))
    return [np.asarray(g, np.float32) for g in grads] + [None] * (3 - len(grads))


def _t(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(a).to(dtype)


def _max_abs_close(got, want, frac):
    """|got - want| within `frac` of max |want|."""
    np.testing.assert_allclose(got, want, atol=frac * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("B,H,W,ws,heads,kd,dv,layout,use_mask,use_qb", CASES)
def test_bwd_ref_matches_jax_kernel(B, H, W, ws, heads, kd, dv, layout,
                                    use_mask, use_qb):
    qkv, bias, mask, qb, dout = _inputs(0, B, H, W, ws, heads, kd, dv,
                                        use_mask, use_qb)
    kw = dict(window=ws, heads=heads, kd=kd, dv=dv, layout=layout)
    want = _jax_grads(qkv, bias, mask, qb, dout, jnp.float32, **kw)
    got = wa.window_attention_bwd_ref(_t(qkv), _t(bias), _t(mask), _t(dout),
                                      qkv_bias=_t(qb), **kw)
    # fp32 on both sides, sums in other orders: the Pallas tests' tolerance
    np.testing.assert_allclose(got[0].numpy(), want[0], atol=2e-5, rtol=1e-4)
    # sums over every window and token: within 1e-4 of the largest
    _max_abs_close(got[1].numpy(), want[1], 1e-4)
    if use_qb:
        _max_abs_close(got[2].numpy(), want[2], 1e-4)
    else:
        assert got[2] is None


def test_bwd_ref_bf16_rounds_like_jax():
    """bf16 qkv: the same rounding points (bias-folded q/k/v and dqkv in
    bf16, fp32 P and sums) give dqkv within two ulps at max |dqkv|."""
    B, H, W, ws, heads, kd, dv, layout, _, _ = CASES[0]
    qkv, bias, _, qb, dout = _inputs(1, B, H, W, ws, heads, kd, dv, False, True)
    kw = dict(window=ws, heads=heads, kd=kd, dv=dv, layout=layout)
    want = _jax_grads(qkv, bias, None, qb, dout, jnp.bfloat16, **kw)
    got = wa.window_attention_bwd_ref(_t(qkv, torch.bfloat16), _t(bias), None,
                                      _t(dout, torch.bfloat16), qkv_bias=_t(qb), **kw)
    assert got[0].dtype == torch.bfloat16 and got[2].dtype == torch.bfloat16
    top = np.abs(want[0]).max()
    two_ulps = 2.0 ** (np.floor(np.log2(top)) - 6)
    np.testing.assert_allclose(got[0].float().numpy(), want[0], atol=two_ulps, rtol=0)
    _max_abs_close(got[1].numpy(), want[1], 1e-3)      # fp32 from bf16 inputs


@pytest.mark.parametrize("case", [0, 2])
def test_autograd_function_gives_plain_grads_on_cpu(case):
    B, H, W, ws, heads, kd, dv, layout, use_mask, _ = CASES[case]
    qkv, bias, mask, qb, dout = _inputs(2, B, H, W, ws, heads, kd, dv,
                                        use_mask, True)
    kw = dict(window=ws, heads=heads, kd=kd, dv=dv, layout=layout)
    leaves = [_t(a).requires_grad_() for a in (qkv, bias, qb)]
    before = (wa.LAUNCHES, wa.BWD_LAUNCHES)
    out = wa.fused_window_attention(leaves[0], leaves[1], _t(mask),
                                    qkv_bias=leaves[2], **kw)
    grads = torch.autograd.grad(out, leaves, _t(dout))
    want = wa.window_attention_bwd_ref(_t(qkv), _t(bias), _t(mask), _t(dout),
                                       qkv_bias=_t(qb), **kw)
    # the same plain functions on the same inputs: bit-identical
    for g, w in zip(grads, want):
        assert torch.equal(g, w)
    assert (wa.LAUNCHES, wa.BWD_LAUNCHES) == before      # no kernel on the CPU
    # and the plain backward is the gradient of the plain forward (fp32)
    leaves2 = [_t(a).requires_grad_() for a in (qkv, bias, qb)]
    ref = wa.window_attention_ref(leaves2[0], leaves2[1], _t(mask),
                                  qkv_bias=leaves2[2], **kw)
    for g, w in zip(grads, torch.autograd.grad(ref, leaves2, _t(dout))):
        torch.testing.assert_close(g, w, atol=1e-5 * w.abs().max().item(), rtol=0)


def test_autograd_function_grads_only_what_is_asked():
    qkv, bias, _, qb, dout = _inputs(3, 1, 14, 14, 7, 2, 16, 16, False, True)
    kw = dict(window=7, heads=2, kd=16, dv=16)
    q = _t(qkv).requires_grad_()
    out = wa.fused_window_attention(q, _t(bias), qkv_bias=_t(qb), **kw)
    (dq,) = torch.autograd.grad(out, [q], _t(dout))
    want = wa.window_attention_bwd_ref(_t(qkv), _t(bias), None, _t(dout),
                                       qkv_bias=_t(qb), **kw)[0]
    assert torch.equal(dq, want)


def test_bwd_wrapper_checks_the_cotangent():
    qkv = torch.zeros(1, 14, 14, 2 * 96)
    bias = torch.zeros(2, 49, 49)
    kw = dict(window=7, heads=2, kd=32, dv=32)
    with pytest.raises(ValueError):
        wa.fused_window_attention_bwd(qkv, bias, None, torch.zeros(1, 14, 14, 32), **kw)
    got = wa.fused_window_attention_bwd(qkv, bias, None, torch.zeros(1, 14, 14, 64), **kw)
    assert got[0].shape == qkv.shape and got[1].shape == bias.shape and got[2] is None


def _hi_lo(x):
    """x as the tensor-core K2 feeds it to a product: hi = bf16(x),
    lo = bf16(x - hi), both back in fp32."""
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float()


def _emulate_k2(qkv, bias, mask, dout, qb, *, split, window, heads, kd, dv, layout):
    """fp32 dqkv (B, H, W, L) of K2 before its rounding to bf16, in torch.
    S and dP are bf16 x bf16 products with fp32 sums (exact on the tensor
    cores); P and dS are fp32. With `split`, the three products with an fp32
    operand (dQ = dS.K, dK = dS^T.Q, dV = P^T.dO) take it as hi + lo, two
    products summed in fp32, as the kernel's two mma passes into one
    accumulator do; without it, they take the fp32 values, as
    `window_attention_bwd_ref` does."""
    B, H, W, _ = qkv.shape
    xb = qkv if qb is None else qkv + qb.to(qkv.dtype)
    w, padded = window_partition(xb, window)
    q, k, v = (t.float() for t in wa.split_qkv(w, layout, heads, kd, dv))
    do = window_partition(dout, window)[0].unflatten(-1, (heads, dv)).float()
    p = torch.softmax(wa._scores(q, k, bias, mask), dim=-1)
    dp = torch.einsum("bnhd,bmhd->bhnm", do, v)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    terms = (_hi_lo(p), _hi_lo(ds)) if split else ((p,), (ds,))
    scale = kd ** -0.5
    dq = sum(torch.einsum("bhnm,bmhk->bnhk", t, k) for t in terms[1]) * scale
    dk = sum(torch.einsum("bhnm,bnhk->bmhk", t, q) for t in terms[1]) * scale
    dvv = sum(torch.einsum("bhnm,bnhd->bmhd", t, do) for t in terms[0])
    return window_reverse(wa.pack_qkv(dq, dk, dvv, layout), window, padded, (H, W))


@pytest.mark.parametrize("B,H,W,ws,heads,kd,dv,layout,use_mask,use_qb", CASES)
def test_k2_hi_lo_products_match_jax_kernel(B, H, W, ws, heads, kd, dv, layout,
                                            use_mask, use_qb):
    """The tensor-core K2's products with an fp32 operand split hi/lo: in bf16
    within two ulps at the largest |dqkv| of the JAX kernel pair (the bound
    the card holds K2 to), and before the rounding to bf16 within a quarter
    of that bound of the fp32 products `window_attention_bwd_ref` rounds."""
    qkv, bias, mask, qb, dout = _inputs(4, B, H, W, ws, heads, kd, dv, use_mask, use_qb)
    kw = dict(window=ws, heads=heads, kd=kd, dv=dv, layout=layout)
    want = _jax_grads(qkv, bias, mask, qb, dout, jnp.bfloat16, **kw)[0]
    args = (_t(qkv, torch.bfloat16), _t(bias), _t(mask), _t(dout, torch.bfloat16), _t(qb))
    got = _emulate_k2(*args, split=True, **kw)
    exact = _emulate_k2(*args, split=False, **kw)
    top = np.abs(want).max()
    two_ulps = 2.0 ** (np.floor(np.log2(top)) - 6)
    np.testing.assert_allclose(got.bfloat16().float().numpy(), want, atol=two_ulps, rtol=0)
    assert (got - exact).abs().max().item() <= 0.25 * two_ulps
    # without the split, the emulation is the plain version, bit for bit
    ref = wa.window_attention_bwd_ref(args[0], args[1], args[2], args[3], qkv_bias=args[4], **kw)
    assert torch.equal(exact.bfloat16(), ref[0])

