"""cream_tpu_torch's layout pin (K11's plain version, TinyViT `pin_layouts`)
vs the JAX package's.

The JAX side runs its Pallas copy `layout_pin(x, interpret=True)` on the CPU
and its TinyViT with `pin_layouts=True`; the port's side is `layout_pin_ref`,
the plain version the CUDA kernel is held to on the card (bit for bit), the
autograd.Function `layout_pin`, and the port's TinyViT with `pin_layouts`.
Weights are the port's seeded ones; inputs come from numpy seeds.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cream_tpu.models.tinyvit import TinyViT as JaxTinyViT
from cream_tpu.ops.pallas.layout_pin import layout_pin as jax_layout_pin
from cream_tpu.zoo.import_torch import convert_tinyvit
from cream_tpu_torch.models.tinyvit import TinyViT
from cream_tpu_torch.ops import layout_pin
from cream_tpu_torch.train.steps import loss_and_grads, step_generator
from cream_tpu_torch.train.losses import soft_target_ce
from cream_tpu_torch.zoo.load import seeded_state_dict
from torch_threads import one_torch_thread_module  # noqa: F401


def _input(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_plain_equals_jax_kernel_bitwise(dtype):
    x = jnp.asarray(_input((3, 14, 14, 384)), dtype)
    want = np.asarray(jax_layout_pin(x, True).astype(jnp.float32))
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        torch.float32 if dtype == jnp.float32 else torch.bfloat16)
    got = layout_pin.layout_pin(xt)
    assert got.data_ptr() != xt.data_ptr() and got.is_contiguous()
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_grad_is_the_identity():
    x = torch.from_numpy(_input((2, 7, 7, 16))).requires_grad_()
    dy = torch.from_numpy(_input((2, 7, 7, 16), seed=1))
    y = layout_pin.layout_pin(x)
    assert torch.equal(y, x)
    (g,) = torch.autograd.grad(y, x, dy)
    assert torch.equal(g, dy)


NARROW = dict(embed_dims=(32, 32, 64, 64), depths=(1, 2, 1, 1),
              num_heads=(1, 1, 2, 2), window_sizes=(7, 7, 14, 7), num_classes=10)


def test_narrow_tinyvit_pinned_matches_jax_and_unpinned():
    pinned = TinyViT(img_size=112, device="cpu", pin_layouts=True, **NARROW).eval()
    sd = seeded_state_dict(pinned, 5)
    pinned.load_state_dict(sd)
    plain = TinyViT(img_size=112, device="cpu", **NARROW).eval()
    plain.load_state_dict(sd)
    x = torch.from_numpy(_input((2, 112, 112, 3), seed=7))
    variables = convert_tinyvit({k: v.numpy() for k, v in sd.items()},
                                depths=NARROW["depths"])
    want = np.asarray(jax.jit(JaxTinyViT(pin_layouts=True, **NARROW).apply)(
        variables, jnp.asarray(x.numpy())))
    with torch.inference_mode():
        got = pinned(x)
        assert torch.equal(got, plain(x))               # the identity, bit for bit
    # fp32 through ~20 layers with sums in other orders
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def test_pinned_train_step_equals_unpinned():
    """A train step (drop path drawn from the same generator): the same loss
    and grads bit for bit, the backward passing dy through the pin."""
    results = []
    for pin in (False, True):
        m = TinyViT(img_size=112, device="cpu", pin_layouts=pin, drop_path_rate=0.1,
                    **NARROW).train()
        m.load_state_dict(seeded_state_dict(m, 6))
        batch = {"image": torch.from_numpy(_input((2, 112, 112, 3), seed=8)),
                 "label": torch.eye(10)[torch.tensor([1, 7])]}
        results.append(loss_and_grads(m, batch, soft_target_ce, step_generator(0, 0, "cpu")))
    (loss_a, _, grads_a), (loss_b, _, grads_b) = results
    assert torch.equal(loss_a, loss_b)
    assert grads_a.keys() == grads_b.keys()
    for name in grads_a:
        assert torch.equal(grads_a[name], grads_b[name]), name
