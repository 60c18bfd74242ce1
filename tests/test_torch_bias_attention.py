"""cream_tpu_torch's bias attention (K3's plain version, `BiasAttention`) vs
the JAX package's.

The JAX side runs its Pallas kernel
`cream_tpu.ops.pallas.bias_attention.fused_bias_attention` in interpret mode
on the CPU and its `BiasAttention` module (whose einsum path runs there);
the port's side is `fused_bias_attention_ref`, the plain version the CUDA
kernel is held to on the card, and the port's `BiasAttention`. Weights and
inputs come from numpy seeds and are fed to both.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cream_tpu.nn.attention import BiasAttention as JaxBiasAttention
from cream_tpu.ops.pallas.bias_attention import fused_bias_attention as jax_fused
from cream_tpu_torch.nn.attention import BiasAttention, WindowBiasAttention
from cream_tpu_torch.ops import bias_attention
from cream_tpu_torch.ops.common import attention_bias_indices
from cream_tpu_torch.ops.window import window_partition, window_reverse
from cream_tpu_torch.zoo.load import bias_attention_state_dict_from_jax
from torch_threads import one_torch_thread_module  # noqa: F401


def _np(t):
    return t.detach().float().numpy()


def _bf16_ulp(top):
    """One bf16 ulp at |top| (at least at 1)."""
    return 2.0 ** (np.floor(np.log2(max(1.0, float(top)))) - 7)


def _qkvb(W, h, N, dk, dv, seed):
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((W, h, N, dk)).astype(np.float32) for _ in range(2))
    v = rng.standard_normal((W, h, N, dv)).astype(np.float32)
    bias = rng.standard_normal((h, N, N)).astype(np.float32)
    return q, k, v, bias


# the shapes of the JAX package's own kernel tests (test_pallas_kernels.py):
# TinyViT's 49-token window, EfficientViT's 4x4 window, a 196-token window
# (lane-padded to 256 inside the JAX wrapper) and W = 7 (not a window tile);
# then dk != dv (BiasAttention's attn_ratio); (W, h, N, dk, dv), named
# W-h-N-d where dk = dv = d
PLAIN_CASES = [pytest.param(*c, id="-".join(map(str, c[:4] if c[3] == c[4] else c)))
               for c in [(8, 4, 49, 32, 32), (5, 3, 16, 16, 16), (4, 2, 196, 32, 32),
                         (7, 2, 49, 32, 32), (4, 3, 49, 16, 64), (3, 2, 100, 64, 32),
                         (5, 2, 16, 8, 16), (2, 2, 196, 16, 64)]]


@pytest.mark.parametrize("W,h,N,dk,dv", PLAIN_CASES)
def test_plain_matches_jax_kernel(W, h, N, dk, dv):
    q, k, v, bias = _qkvb(W, h, N, dk, dv, seed=W + N)
    want = np.asarray(jax_fused(*(jnp.asarray(a) for a in (q, k, v, bias)), interpret=True))
    got = bias_attention.fused_bias_attention_ref(*(torch.from_numpy(a) for a in (q, k, v, bias)))
    assert tuple(got.shape) == (W, h, N, dv)
    # fp32: the same rounding points, sums in other orders
    np.testing.assert_allclose(_np(got), want, atol=1e-5, rtol=1e-5)


def test_plain_matches_jax_kernel_bf16():
    q, k, v, bias = _qkvb(8, 4, 49, 32, 32, seed=3)
    want = np.asarray(jax_fused(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                                jnp.asarray(bias), interpret=True).astype(jnp.float32))
    got = bias_attention.fused_bias_attention_ref(
        *(torch.from_numpy(a).bfloat16() for a in (q, k, v)), torch.from_numpy(bias))
    assert got.dtype == torch.bfloat16
    # P and the output round to bf16 at the same points; fp32 sums in other
    # orders may move a rounding by an ulp: 2 ulps at the largest |out|
    assert np.abs(_np(got) - want).max() <= 2 * _bf16_ulp(np.abs(want).max())


def jax_params(dim, kd, heads, d, res, seed):
    rng = np.random.default_rng(seed)
    _, n_off = attention_bias_indices(res)
    L = heads * (2 * kd + d)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"params": {
        "norm": {"scale": rng.uniform(0.5, 1.5, dim).astype(np.float32), "bias": f(dim) * 0.1},
        "qkv": {"kernel": f(dim, L) / np.sqrt(dim), "bias": f(L) * 0.1},
        "proj": {"kernel": f(heads * d, dim) / np.sqrt(heads * d), "bias": f(dim) * 0.1},
        "attention_biases": f(heads, n_off) * 0.5}}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dim,kd,heads,ratio,res", [(64, 16, 4, 4.0, (7, 7)),
                                                    (32, 8, 2, 2.0, (4, 5))])
def test_module_matches_jax(dtype, dim, kd, heads, ratio, res):
    d = int(ratio * kd)
    variables = jax_params(dim, kd, heads, d, res, seed=dim + heads)
    m = BiasAttention(dim, kd, heads, ratio, res, dtype=dtype).eval()
    m.load_state_dict(bias_attention_state_dict_from_jax(variables))
    N = res[0] * res[1]
    x = np.random.default_rng(1).standard_normal((3, N, dim)).astype(np.float32)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jm = JaxBiasAttention(dim, kd, heads, ratio, res, dtype=jdtype)
    want = np.asarray(jm.apply(variables, jnp.asarray(x)).astype(jnp.float32))
    with torch.inference_mode():
        assert not m.kernel_path(torch.from_numpy(x))     # no kernel for CPU tensors
        got = m(torch.from_numpy(x))
    assert got.dtype == dtype and tuple(got.shape) == (3, N, dim)
    if dtype == torch.float32:
        np.testing.assert_allclose(_np(got), want, atol=1e-5, rtol=1e-5)
    else:
        # bf16 LN, GEMMs and P·V, each rounding where the other side's does
        # but summing in another order: 4 ulps at the largest |out|
        assert np.abs(_np(got) - want).max() <= 4 * _bf16_ulp(np.abs(want).max())


def test_windows_equal_window_bias_attention():
    """BiasAttention over partitioned windows is WindowBiasAttention over
    the map, on the same weights (the released names are shared)."""
    dim, kd, heads, ws = 64, 16, 4, 7
    win = WindowBiasAttention(dim, kd, heads, ws, attn_ratio=1.0).eval()
    variables = jax_params(dim, kd, heads, kd, (ws, ws), seed=11)
    sd = bias_attention_state_dict_from_jax(variables)
    win.load_state_dict(sd)
    ba = BiasAttention(dim, kd, heads, 1.0, (ws, ws)).eval()
    ba.load_state_dict(sd)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 14, 21, dim)).astype(np.float32))
    with torch.inference_mode():
        want = win(x)
        w, padded = window_partition(x, ws)
        got = window_reverse(ba(w), ws, padded, (14, 21))
    # fp32: LN and the qkv GEMM on the map vs inside the windows
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_supports_shape_and_refusals():
    assert bias_attention.supports_shape(49, 32, 32)
    assert bias_attention.supports_shape(196, 32, 32)
    assert bias_attention.supports_shape(256, 64, 64)
    assert not bias_attention.supports_shape(257, 16, 16)
    assert not bias_attention.supports_shape(256, 128, 128)       # shared memory
    q, k, v, bias = (torch.from_numpy(a) for a in _qkvb(2, 2, 16, 8, 8, seed=0))
    with pytest.raises(ValueError, match="bias"):
        bias_attention.fused_bias_attention(q, k, v, bias[:1])
    with pytest.raises(ValueError, match="q, k"):
        bias_attention.fused_bias_attention(q, k[:, :, :8], v, bias)
    m = BiasAttention(32, 8, 2, resolution=(4, 4))
    with pytest.raises(ValueError, match="tokens"):
        m(torch.zeros(1, 15, 32))
