"""The JAX package's two gated ConvBN variants in cream_tpu_torch, against
JAX on the CPU in fp32: `ops.bn.bn_train_norm` (the train-mode BN with its
backward folded into dx) and `nn.layers.MXUBatchNorm`, and the 1x1 conv as a
channel product (`ConvBN(conv1x1_dot=...)`, `DEFAULT_CONV1X1_DOT`).

Both gates are off by default on both sides; the tests set the JAX
package's module flags with `monkeypatch`, so they are restored.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cream_tpu.nn import layers as jax_layers
from cream_tpu.models.tinyvit import TinyViT as JaxTinyViT
from cream_tpu.ops import bn as jax_bn
from cream_tpu.train import losses as jax_losses
from cream_tpu.zoo.import_torch import convert_tinyvit
from cream_tpu_torch.models.tinyvit import TinyViT
from cream_tpu_torch.nn import layers
from cream_tpu_torch.ops import bn
from cream_tpu_torch.train import losses
from cream_tpu_torch.train.steps import loss_and_grads
from cream_tpu_torch.zoo.load import seeded_state_dict
from torch_threads import one_torch_thread_module  # noqa: F401

EPS = 1e-5


def _rel(got, want):
    return float(np.linalg.norm(np.asarray(got) - np.asarray(want))
                 / max(np.linalg.norm(np.asarray(want)), 1e-30))


def test_defaults_are_off():
    assert bn.DEFAULT_MXU_BN is False and layers.DEFAULT_CONV1X1_DOT is False
    assert jax_bn.DEFAULT_MXU_BN is False and jax_layers.DEFAULT_CONV1X1_DOT is False


@pytest.mark.parametrize("layout", ["nhwc", "nchw_channels_last"])
def test_bn_train_norm_and_its_vjp_match_jax(layout):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((4, 6, 5, 8)) * 2 + 0.5).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    bias = rng.standard_normal(8).astype(np.float32)
    dy = rng.standard_normal(x.shape).astype(np.float32)

    def jf(x, s, b):
        mu, var = jax_bn._moments(x)
        return jax_bn.bn_train_norm(x, mu, var, s, b, EPS)

    want, vjp = jax.vjp(jf, jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    wdx, wds, wdb = vjp(jnp.asarray(dy))

    tx = torch.tensor(x, requires_grad=True)
    ts, tb = torch.tensor(scale, requires_grad=True), torch.tensor(bias, requires_grad=True)
    if layout == "nhwc":
        mu, var = bn._moments(tx)
        y = bn.bn_train_norm(tx, mu, var, ts, tb, EPS)
    else:
        xin = tx.permute(0, 3, 1, 2)             # channels_last strides, no copy
        assert xin.is_contiguous(memory_format=torch.channels_last)
        mu, var = bn._moments(xin, 1)
        y = bn.bn_train_norm(xin, mu, var, ts, tb, EPS, channel_dim=1)
        assert y.shape == xin.shape and y.is_contiguous(memory_format=torch.channels_last)
        y = y.permute(0, 2, 3, 1)
    gx, gs, gb = torch.autograd.grad(y, (tx, ts, tb), torch.from_numpy(dy), retain_graph=True)
    for got, w in ((y, want), (gx, wdx), (gs, wds), (gb, wdb)):
        assert _rel(got.detach().numpy(), w) < 1e-5
    # mu and var get zero grads: their paths are folded into dx
    gm, gv = torch.autograd.grad(y, (mu, var), torch.from_numpy(dy), allow_unused=True)
    assert not gm.any() and not gv.any()


def test_mxu_batch_norm_two_steps_match_jax():
    rng = np.random.default_rng(1)
    C = 6
    scale = rng.uniform(0.5, 1.5, C).astype(np.float32)
    bias = rng.standard_normal(C).astype(np.float32)
    jm = jax_layers.MXUBatchNorm()
    xs = [(rng.standard_normal((3, 5, 4, C)) * 3 + 1).astype(np.float32) for _ in range(2)]
    variables = jm.init(jax.random.key(0), jnp.asarray(xs[0]))
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": variables["batch_stats"]}
    m = layers.MXUBatchNorm(C)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(scale))
        m.bias.copy_(torch.from_numpy(bias))
    m.train()
    for x in xs:
        want, upd = jm.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
        variables = {"params": variables["params"], "batch_stats": upd["batch_stats"]}
        got = m(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        assert _rel(got.detach().numpy(), want) < 1e-5
    stats = variables["batch_stats"]
    np.testing.assert_allclose(m.running_mean.numpy(), stats["mean"], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(m.running_var.numpy(), stats["var"], rtol=1e-5, atol=1e-7)
    assert int(m.num_batches_tracked) == 2
    # its state dict is BatchNorm2d's
    assert m.state_dict().keys() == torch.nn.BatchNorm2d(C).state_dict().keys()


@pytest.mark.parametrize("stride", [1, 2])
def test_conv1x1_dot_convbn_matches_jax(stride):
    rng = np.random.default_rng(2 + stride)
    C, F = 8, 12
    port = layers.ConvBN(C, F, 1, stride, conv1x1_dot=True)
    conv = layers.ConvBN(C, F, 1, stride)
    sd = {k: torch.from_numpy(rng.uniform(0.5, 1.5, v.shape).astype(np.float32))
          if v.is_floating_point() else v for k, v in port.state_dict().items()}
    port.load_state_dict(sd)
    conv.load_state_dict(sd)            # the same state dict as the conv route
    assert port.state_dict().keys() == conv.state_dict().keys()
    x = rng.standard_normal((2, 9, 7, C)).astype(np.float32)
    jm = jax_layers.ConvBN(features=F, kernel_size=1, stride=stride, conv1x1_dot=True)
    variables = {"params": {"conv": {"kernel": jnp.asarray(sd["c.weight"].permute(2, 3, 1, 0)
                                                           .numpy())},
                            "bn": {"scale": jnp.asarray(sd["bn.weight"].numpy()),
                                   "bias": jnp.asarray(sd["bn.bias"].numpy())}},
                 "batch_stats": {"bn": {"mean": jnp.asarray(sd["bn.running_mean"].numpy()),
                                        "var": jnp.asarray(sd["bn.running_var"].numpy())}}}
    for train in (False, True):
        port.train(train)
        conv.train(train)
        want = jm.apply(variables, jnp.asarray(x), train=train,
                        mutable=["batch_stats"] if train else False)
        want = want[0] if train else want
        got = port(torch.from_numpy(x))
        assert got.shape == want.shape == (2, -(-9 // stride), -(-7 // stride), F)
        assert _rel(got.detach().numpy(), want) < 1e-5
        assert _rel(got.detach().numpy(), conv(torch.from_numpy(x)).detach().numpy()) < 1e-5


NARROW = dict(embed_dims=(32, 32, 64, 64), depths=(1, 2, 1, 1), num_heads=(1, 1, 2, 2),
              window_sizes=(7, 7, 14, 7), num_classes=10)
IMG, BATCH = 64, 4


def test_gated_tinyvit_step_matches_jax_with_both_gates(monkeypatch):
    """A narrow TinyViT (the 5M's windows, narrower widths and depths) with
    both gates on, one train step's loss and per-tensor grad norms against
    JAX's with both gates on."""
    monkeypatch.setattr(jax_bn, "DEFAULT_MXU_BN", True)
    monkeypatch.setattr(jax_layers, "DEFAULT_CONV1X1_DOT", True)
    monkeypatch.setattr(bn, "DEFAULT_MXU_BN", True)
    monkeypatch.setattr(layers, "DEFAULT_CONV1X1_DOT", True)
    m = TinyViT(img_size=IMG, device="cpu", drop_path_rate=0.0, **NARROW)
    m.load_state_dict(seeded_state_dict(m, 5))
    sd = {k: v.detach().numpy().copy() for k, v in m.state_dict().items()}
    variables = convert_tinyvit(sd, depths=NARROW["depths"])
    rng = np.random.default_rng(7)
    x = rng.standard_normal((BATCH, IMG, IMG, 3)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, BATCH)]
    loss, _, grads = loss_and_grads(m, {"image": torch.from_numpy(x),
                                        "label": torch.from_numpy(y)}, losses.soft_target_ce)
    jm = JaxTinyViT(drop_path_rate=0.0, **NARROW)

    def f(p):
        logits, _ = jm.apply({"params": p, "batch_stats": variables["batch_stats"]},
                             jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jax_losses.soft_target_ce(logits, jnp.asarray(y))

    jloss, jgrads = jax.jit(jax.value_and_grad(f))(variables["params"])
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    # each grad tensor's norm, through the weight bridge's layout
    got = convert_tinyvit({**sd, **{k: g.numpy() for k, g in grads.items()}},
                          depths=NARROW["depths"])["params"]
    flat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    gflat = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(flat) == len(gflat) == len(grads)
    # a grad at float noise (a bias right before a train-mode BN) is held
    # at the noise floor, 1e-7 of the global grad norm
    floor = 1e-7 * np.sqrt(sum(np.vdot(v, v) for _, v in flat))
    for path, w in flat:
        wn, gn = np.linalg.norm(np.asarray(w)), np.linalg.norm(np.asarray(gflat[path]))
        assert abs(gn - wn) <= 1e-3 * wn + floor, (jax.tree_util.keystr(path), gn, wn)
