"""cream_tpu_torch building blocks vs the JAX package's, on shared weights.

Each port module gets seeded weights (`seeded_state_dict`); the same arrays,
laid out the flax way, go to the flax module; inputs come from numpy. fp32
on both sides (the conftest sets JAX matmuls to full precision).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cream_tpu.nn import act as jax_act
from cream_tpu.nn import attention as jax_attention
from cream_tpu.nn import layers as jax_layers
from cream_tpu.ops.common import attention_bias_indices as jax_bias_indices
from cream_tpu.ops.window import (window_partition as jax_partition,
                                  window_reverse as jax_reverse)
from cream_tpu_torch.nn.act import gelu
from cream_tpu_torch.nn.attention import WindowBiasAttention, fits_kernel
from cream_tpu_torch.nn.layers import ConvBN, MBConv, MlpLN, linear
from cream_tpu_torch.ops.common import attention_bias_indices, drop_path
from cream_tpu_torch.ops.window import window_partition, window_reverse
from cream_tpu_torch.zoo.load import seeded_state_dict
from torch_threads import one_torch_thread_module  # noqa: F401


def _np(t):
    return t.detach().cpu().numpy()


def _seeded(module, seed=0):
    module.load_state_dict(seeded_state_dict(module, seed))
    return module.eval()


def conv_bn_vars(m: ConvBN):
    params = {"conv": {"kernel": _np(m.c.weight).transpose(2, 3, 1, 0)},
              "bn": {"scale": _np(m.bn.weight), "bias": _np(m.bn.bias)}}
    stats = {"bn": {"mean": _np(m.bn.running_mean), "var": _np(m.bn.running_var)}}
    return params, stats


def ln_vars(norm):
    return {"scale": _np(norm.weight), "bias": _np(norm.bias)}


def dense_vars(fc):
    return {"kernel": _np(fc.weight).T, "bias": _np(fc.bias)}


def _input(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _port(module, x):
    with torch.inference_mode():
        return _np(module(torch.from_numpy(x)))


@pytest.mark.parametrize("res", [(7, 7), (14, 14), (4, 4), (5, 3)])
def test_attention_bias_indices_identical(res):
    idx, n = attention_bias_indices(res)
    jidx, jn = jax_bias_indices(res)
    assert n == jn and idx.dtype == jidx.dtype
    np.testing.assert_array_equal(idx, jidx)


@pytest.mark.parametrize("shape,ws", [((2, 14, 14, 8), 7), ((2, 13, 10, 8), 7),
                                      ((1, 5, 9, 4), 4)])
def test_window_partition_reverse_exact(shape, ws):
    x = _input(shape)
    w, padded = window_partition(torch.from_numpy(x), ws)
    jw, jpadded = jax_partition(jnp.asarray(x), ws)
    assert padded == jpadded
    np.testing.assert_array_equal(_np(w), np.asarray(jw))
    back = window_reverse(w, ws, padded, shape[1:3])
    np.testing.assert_array_equal(_np(back), np.asarray(jax_reverse(jw, ws, jpadded, shape[1:3])))
    np.testing.assert_array_equal(_np(back), x)


def test_drop_path():
    x = torch.from_numpy(_input((64, 3, 5)))
    # eval, or rate 0: the input itself, as in the JAX package
    assert drop_path(x, 0.3, deterministic=True) is x
    assert drop_path(x, 0.0, deterministic=False) is x
    with pytest.raises(ValueError):                 # training needs randomness
        drop_path(x, 0.3, deterministic=False)
    gen = lambda: torch.Generator().manual_seed(3)
    y = drop_path(x, 0.25, deterministic=False, generator=gen())
    torch.testing.assert_close(y, drop_path(x, 0.25, deterministic=False, generator=gen()),
                               atol=0, rtol=0)
    # per sample: dropped whole, or kept and rescaled by 1/(1-rate)
    kept = y.flatten(1).ne(0).any(1)
    assert 0 < kept.sum() < len(x)
    torch.testing.assert_close(y[kept], x[kept] / 0.75)
    assert not y[~kept].any()


def test_gelu_fp32_is_erf():
    x = _input((4, 257)) * 3
    got = _np(gelu(torch.from_numpy(x)))
    # same exact-erf formula, float32 rounding on both sides
    np.testing.assert_allclose(got, np.asarray(jax_act.gelu(jnp.asarray(x))),
                               atol=1e-6, rtol=1e-6)


def test_gelu_bf16_is_tanh():
    x = _input((4, 257)) * 3
    got = gelu(torch.from_numpy(x).bfloat16())
    want = jax_act.gelu(jnp.asarray(x, jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    # tanh form on both sides; each rounds to bf16 (2^-8 relative) at its own
    # steps: allow two bf16 ulps
    np.testing.assert_allclose(_np(got.float()), np.asarray(want, np.float32),
                               atol=1e-2, rtol=2 ** -7)


@pytest.mark.parametrize("cin,cout,k,stride,pad,groups", [
    (8, 16, 1, 1, 0, 1),       # pointwise
    (8, 16, 3, 2, 1, 1),       # 3x3 stride 2 (patch embed)
    (16, 16, 3, 1, 1, 16),     # depthwise (local conv, MBConv)
    (16, 16, 3, 2, 1, 16),     # depthwise stride 2 (PatchMerging)
])
def test_conv_bn_matches_flax(cin, cout, k, stride, pad, groups):
    m = _seeded(ConvBN(cin, cout, k, stride, pad, groups=groups))
    x = _input((2, 9, 9, cin))
    params, stats = conv_bn_vars(m)
    want = jax_layers.ConvBN(cout, k, stride, pad, groups).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x))
    # fp32 convolution sums in another order
    np.testing.assert_allclose(_port(m, x), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_mbconv_matches_flax():
    m = _seeded(MBConv(16, 4.0))
    params, stats = {}, {}
    for c in ("conv1", "conv2", "conv3"):
        params[c], stats[c] = conv_bn_vars(getattr(m, c))
    x = _input((2, 9, 9, 16))
    want = jax_layers.MBConv(16, 4.0).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x))
    np.testing.assert_allclose(_port(m, x), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_mlp_ln_matches_flax():
    m = _seeded(MlpLN(16, 64, 16))
    params = {"norm": ln_vars(m.norm), "fc1": dense_vars(m.fc1),
              "fc2": dense_vars(m.fc2)}
    x = _input((2, 5, 5, 16))
    want = jax_layers.MlpLN(64, 16).apply({"params": params}, jnp.asarray(x))
    np.testing.assert_allclose(_port(m, x), np.asarray(want), atol=1e-5, rtol=1e-5)


def _attention_pair(dim, heads, window):
    m = _seeded(WindowBiasAttention(dim, dim // heads, heads, window))
    params = {"norm": ln_vars(m.norm), "qkv": dense_vars(m.qkv),
              "proj": dense_vars(m.proj),
              "attention_biases": _np(m.attention_biases)}
    jm = jax_attention.WindowBiasAttention(dim, dim // heads, heads, window)
    return m, lambda x: np.asarray(jm.apply({"params": params}, jnp.asarray(x)))


@pytest.mark.parametrize("shape,heads,window", [
    ((2, 14, 14, 64), 2, 7),     # whole windows: the kernel's shape
    ((1, 14, 14, 64), 4, 14),    # one 196-token window
    ((2, 13, 10, 64), 2, 7),     # zero-padded windows: plain path only
])
def test_window_bias_attention_matches_flax(shape, heads, window):
    m, jax_fn = _attention_pair(shape[-1], heads, window)
    x = _input(shape)
    want = jax_fn(x)
    np.testing.assert_allclose(_port(m, x), want, atol=1e-5, rtol=1e-5)
    if fits_kernel(shape[1], shape[2], window):
        # whole windows: forward() ran LN and the GEMM on the map; the
        # reference order (partition first, LN in the windows) agrees too
        with torch.inference_mode():
            xt = torch.from_numpy(x)
            bias = m.attention_biases[:, m.attention_bias_idxs]
            windowed = linear(m.proj, m.forward_windowed(xt, bias), torch.float32)
        np.testing.assert_allclose(_np(windowed), want, atol=1e-5, rtol=1e-5)


def test_kernel_path_rule():
    assert fits_kernel(28, 28, 7) and fits_kernel(14, 14, 14) and fits_kernel(16, 16, 16)
    assert not fits_kernel(13, 14, 7) and not fits_kernel(14, 10, 7)
    assert not fits_kernel(17, 17, 17)             # 289 tokens
    m = WindowBiasAttention(64, 32, 2, 7)
    x = torch.zeros(1, 14, 14, 64)
    assert not m.kernel_path(x)                     # no kernel for CPU tensors
    with pytest.raises(ValueError):
        m(torch.zeros(1, 6, 14, 64))                # smaller than the window
