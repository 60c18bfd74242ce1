"""cream_tpu_torch's window relayout (K10's plain versions) vs the JAX package's.

The JAX side runs its Pallas kernels `window_partition_pallas` /
`window_reverse_pallas` in interpret mode on the CPU; the port's side is
`window_partition_ref` / `window_reverse_ref`, the plain versions the CUDA
kernels are held to on the card (bit for bit: they only move values), and
`WindowBiasAttention.forward_windowed`, whose eval path on the card takes
them. Inputs come from numpy seeds.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cream_tpu.nn.attention import WindowBiasAttention as JaxWindowBiasAttention
from cream_tpu.ops.pallas.window_relayout import (window_partition_pallas,
                                                  window_reverse_pallas)
from cream_tpu_torch.nn.attention import WindowBiasAttention, fits_kernel
from cream_tpu_torch.ops import window_relayout
from cream_tpu_torch.zoo.load import seeded_state_dict
from torch_threads import one_torch_thread_module  # noqa: F401


def _input(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# the shapes of the JAX package's own relayout test (test_pallas_kernels.py)
@pytest.mark.parametrize("B,H,W,ws,C", [(2, 28, 28, 7, 192), (3, 14, 14, 7, 64),
                                        (1, 24, 24, 12, 96)])
def test_plain_matches_jax_kernels_exactly(B, H, W, ws, C):
    x = _input((B, H, W, C))
    want = np.asarray(window_partition_pallas(jnp.asarray(x), ws, interpret=True))
    got = window_relayout.window_partition_kernel(torch.from_numpy(x), ws)
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    back_want = np.asarray(window_reverse_pallas(jnp.asarray(want), ws, (H, W), interpret=True))
    back = window_relayout.window_reverse_kernel(got, ws, (H, W))
    assert back.is_contiguous()
    np.testing.assert_array_equal(back.numpy(), back_want)
    np.testing.assert_array_equal(back.numpy(), x)


def test_bf16_round_trip_is_exact():
    x = torch.from_numpy(_input((2, 12, 8, 48))).bfloat16()
    w = window_relayout.window_partition_kernel(x, 4)
    assert w.dtype == torch.bfloat16 and tuple(w.shape) == (12, 16, 48)
    assert torch.equal(window_relayout.window_reverse_kernel(w, 4, (12, 8)), x)


def test_ragged_maps_raise():
    with pytest.raises(ValueError, match="whole"):
        window_relayout.window_partition_kernel(torch.zeros(1, 13, 14, 8), 7)
    with pytest.raises(ValueError, match="whole"):
        window_relayout.window_reverse_kernel(torch.zeros(4, 49, 8), 7, (14, 13))
    with pytest.raises(ValueError, match="tile"):
        window_relayout.window_reverse_kernel(torch.zeros(3, 49, 8), 7, (14, 14))


@pytest.mark.parametrize("relayout", [False, True])
def test_whole_window_attention_beyond_256_tokens_matches_jax(relayout, monkeypatch):
    """An 18x18 window (324 tokens, above K1's 256) takes forward_windowed;
    `relayout` routes its partition and reverse through the K10 wrappers, as
    eval on the card does (their plain versions run on the CPU)."""
    dim, heads, ws = 32, 2, 18
    m = WindowBiasAttention(dim, dim // heads, heads, ws).eval()
    m.load_state_dict(seeded_state_dict(m, 4))
    x = _input((2, 18, 18, dim), seed=5)
    assert not fits_kernel(18, 18, ws)
    calls = []
    if relayout:
        for name in ("window_partition_kernel", "window_reverse_kernel"):
            fn = getattr(window_relayout, name)
            monkeypatch.setattr(window_relayout, name,
                                lambda *a, fn=fn, name=name: calls.append(name) or fn(*a))
        monkeypatch.setattr(WindowBiasAttention, "relayout_path", lambda self, x: True)
    with torch.inference_mode():
        got = m(torch.from_numpy(x)).numpy()
    assert len(calls) == (2 if relayout else 0)
    sd = {k: v.numpy() for k, v in m.state_dict().items()}
    params = {"norm": {"scale": sd["norm.weight"], "bias": sd["norm.bias"]},
              "qkv": {"kernel": sd["qkv.weight"].T, "bias": sd["qkv.bias"]},
              "proj": {"kernel": sd["proj.weight"].T, "bias": sd["proj.bias"]},
              "attention_biases": sd["attention_biases"]}
    jm = JaxWindowBiasAttention(dim, dim // heads, heads, ws)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_relayout_route_rule():
    m = WindowBiasAttention(32, 16, 2, 18)
    x = torch.zeros(1, 18, 18, 32)
    with torch.inference_mode():
        assert not m.relayout_path(x)                   # no kernel for CPU tensors
