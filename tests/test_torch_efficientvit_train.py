"""cream_tpu_torch's EfficientViT in train mode vs the JAX package's, fp32 on
the CPU.

The centre is a 3-step train parity run of a narrow EfficientViT (depth
1/1/1, kernels 7/5/3/3, img 128: maps 8/4/2, so stage 0's 8x8 map pads to
7x7 windows and both subsample depthwise convs are stride-2 eligible) on
each depthwise route of the port, against JAX's `make_train_step` on the
same converted weights: loss, grads, params and BN running stats. On the CPU
the port's kernel routes run their plain versions and JAX runs its XLA conv.
Around it: the full-width M5 train step held to a stored JAX golden, the
distillation head's train-mode pair and a bf16 train-mode CGA forward.

Regenerate the golden file (one fp32 JAX train step of EfficientViT-M5 at
B=8 on the seeded weights) with
    python tests/test_torch_efficientvit_train.py
"""
import copy
from pathlib import Path

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from cream_tpu.models import create_model as jax_create_model
from cream_tpu.models.efficientvit import CascadedGroupAttention as JaxCGA
from cream_tpu.models.efficientvit import EfficientViT as JaxEfficientViT
from cream_tpu.train import TrainState as JaxTrainState
from cream_tpu.train import losses as jax_losses
from cream_tpu.train import make_train_step as jax_make_train_step
from cream_tpu.train import optim as jax_optim
from cream_tpu.zoo.import_torch import convert_efficientvit
from cream_tpu_torch.models import create_model
from cream_tpu_torch.models.efficientvit import (_CONFIGS, CascadedGroupAttention,
                                                EfficientViT)
from cream_tpu_torch.nn.layers import DW_KERNELS
from cream_tpu_torch.train import losses, optim
from cream_tpu_torch.train.state import TrainState
from cream_tpu_torch.train.steps import loss_and_grads, make_train_step
from cream_tpu_torch.zoo.load import seeded_state_dict

from test_torch_cga import cga_variables
from torch_threads import one_torch_thread_module  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "data" / "torch_port" / "efficientvit_m5_train_seed0.npz"
WEIGHT_SEED, INPUT_SEED = 0, 1
GOLDEN_BATCH = 8       # at B=2 the head's BN over two samples makes the grads noisier

NARROW = dict(embed_dim=(48, 48, 64), key_dim=(8, 8, 8), depth=(1, 1, 1),
              num_heads=(3, 3, 4), window_size=(7, 7, 7), kernels=(7, 5, 3, 3),
              num_classes=10)
IMG, BATCH = 128, 4
BATCH_SEEDS = (10, 11, 12)
LR = dict(base_lr=1e-3, warmup_steps=1, total_steps=5, warmup_init_lr=1e-4,
          min_lr=1e-5)


def _np(t):
    """A numpy copy (a view would follow the port's in-place updates)."""
    return t.detach().float().cpu().numpy().copy()


def _leaves(tree) -> dict[str, np.ndarray]:
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in flat}


def _jax_tree(model, tensors: dict, depths, num_heads) -> dict:
    """Port tensors keyed by param name (params or grads), with the model's
    buffers, in the JAX package's variable layout."""
    params = dict(model.named_parameters())
    buffers = {k: _np(v) for k, v in model.state_dict().items() if k not in params}
    return convert_efficientvit({**buffers, **{k: _np(v) for k, v in tensors.items()}},
                                depths=depths, num_heads=num_heads)


def _batch(seed, batch=BATCH, img=IMG, num_classes=10):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, img, img, 3)).astype(np.float32)
    labels = rng.integers(0, num_classes, batch)
    return x, np.eye(num_classes, dtype=np.float32)[labels]


def _narrow_port(dw_kernel="library", **kw):
    m = EfficientViT(img_size=IMG, device="cpu", dw_kernel=dw_kernel, **NARROW, **kw)
    m.load_state_dict(seeded_state_dict(m, 5))
    return m


def _jax_loss_and_grads(jm):
    """(params, batch_stats, x, y) -> the JAX train step's loss and raw
    grads, jitted once."""
    def f(p, batch_stats, x, y):
        logits, _ = jm.apply({"params": p, "batch_stats": batch_stats}, x,
                             train=True, mutable=["batch_stats"])
        return jax_losses.soft_target_ce(logits, y)
    return jax.jit(jax.value_and_grad(f))


@pytest.fixture(scope="module")
def jax_narrow_run():
    """JAX's 3 train steps of the narrow model: each step's metrics, the BN
    stats after step 1, and the final state."""
    m = _narrow_port()
    variables = convert_efficientvit({k: _np(v) for k, v in m.state_dict().items()},
                                     depths=NARROW["depth"], num_heads=NARROW["num_heads"])
    jm = JaxEfficientViT(img_size=IMG, **NARROW)
    jtx = jax_optim.make_adamw(jax_optim.cosine_schedule(*LR.values()), weight_decay=0.05,
                               clip_grad=5.0, params=variables["params"])
    jstate = JaxTrainState.create(params=variables["params"], tx=jtx,
                                  batch_stats=variables["batch_stats"])
    jstep = jax_make_train_step(jm, loss_fn=jax_losses.soft_target_ce, donate=False)
    steps = []
    for seed in BATCH_SEEDS:
        x, y = _batch(seed)
        jstate, jmetrics = jstep(jstate, {"image": jnp.asarray(x), "label": jnp.asarray(y)},
                                 jax.random.key(0))
        steps.append({"stats": _leaves(jstate.batch_stats), "loss": float(jmetrics["loss"]),
                      "grad_norm": float(jmetrics["grad_norm"])})
    return steps, _leaves(jstate.params), _leaves(jstate.batch_stats)


@pytest.mark.parametrize("route", DW_KERNELS)
def test_narrow_three_train_steps_match_jax(jax_narrow_run, route):
    """Loss, grad norm, BN running stats and params of 3 AdamW steps.

    A ReLU network's grads jump where a pre-activation sits within fp32
    noise of 0, and at these widths some ReLU input of a batch does: both
    sides are right, their fp32 sums round the other way (and flax takes the
    variance as E[x^2] - E[x]^2). So the raw grads are not held per tensor
    here (the full-width golden test holds per-tensor grad norms), and the
    step-1 loss and grad norm are held to 1e-4. Adam's first update is
    ~lr*sign(g) per element, so a weight whose grad is such noise on one side
    (a ReLU unit alive in one pixel on one side only) moves by lr there and
    not on the other; the loss and grad norm of steps 2 and 3 follow it and
    are held to 2e-2, the params to 2*(sum of the lrs)."""
    steps, jparams, jstats = jax_narrow_run
    m = _narrow_port(route)
    dn = dict(depths=NARROW["depth"], num_heads=NARROW["num_heads"])
    tx = optim.make_adamw(optim.cosine_schedule(*LR.values()), weight_decay=0.05,
                          clip_grad=5.0, params=dict(m.named_parameters()))
    state = TrainState(m, tx)
    step = make_train_step(loss_fn=losses.soft_target_ce)
    lrs = []
    for seed, want in zip(BATCH_SEEDS, steps):
        x, y = _batch(seed)
        lrs.append(state.tx.lr())
        state, metrics = step(state, {"image": torch.from_numpy(x), "label": torch.from_numpy(y)})
        rtol = 1e-4 if len(lrs) == 1 else 2e-2
        np.testing.assert_allclose(float(metrics["loss"]), want["loss"], rtol=rtol)
        np.testing.assert_allclose(float(metrics["grad_norm"]), want["grad_norm"], rtol=rtol)
        assert float(metrics["grad_norm"]) > 5.0         # the clip is active
        if len(lrs) == 1:
            # BN running stats after one step, while the params still agree
            # (the CGA's BNs see stage 0's zero-padded window tokens too)
            stats = _leaves(_jax_tree(m, state.params, **dn)["batch_stats"])
            assert set(stats) == set(want["stats"])
            for k, w in want["stats"].items():
                np.testing.assert_allclose(stats[k], w, rtol=1e-5, atol=1e-6, err_msg=k)
    tol = 2 * sum(lrs)
    got = _jax_tree(m, state.params, **dn)
    for k, w in jparams.items():
        np.testing.assert_allclose(_leaves(got["params"])[k], w, atol=tol, rtol=0, err_msg=k)
    for k, w in jstats.items():
        np.testing.assert_allclose(_leaves(got["batch_stats"])[k], w,
                                   atol=tol * np.abs(w).max(), rtol=0, err_msg=k)
    assert state.step == 3


def test_distillation_train_pair_matches_jax():
    m = _narrow_port(distillation=True)
    variables = convert_efficientvit({k: _np(v) for k, v in m.state_dict().items()},
                                     depths=NARROW["depth"], num_heads=NARROW["num_heads"])
    jm = JaxEfficientViT(img_size=IMG, distillation=True, **NARROW)
    x, _ = _batch(20)
    (want, want_dist), _ = jax.jit(lambda v, x: jm.apply(v, x, train=True,
                                                         mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    got = m.train()(torch.from_numpy(x))
    assert isinstance(got, tuple) and len(got) == 2
    for g, w in zip(got, (want, want_dist)):
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=1e-4, rtol=1e-4)
    with torch.no_grad():                             # eval: the mean of the two
        avg = m.eval()(torch.from_numpy(x))
    assert avg.shape == (BATCH, 10)


def test_bf16_train_mode_cga_matches_jax_module():
    """The CGA module in bf16 in train mode (batch-statistics BN; the plain
    attention whatever the route) against the JAX module in bf16."""
    C, heads, ws, kernels = 192, 3, 7, (7, 5, 3, 3)
    m = CascadedGroupAttention(C, 16, heads, C / 48, ws, kernels, attn_kernel="cascade",
                               device="cpu", dtype=torch.bfloat16).train()
    m.load_state_dict(seeded_state_dict(m, 6))
    variables = cga_variables(m)
    x = np.random.default_rng(6).standard_normal((8, ws, ws, C)).astype(np.float32)
    jm = JaxCGA(C, 16, heads, C / 48, ws, kernels, dtype=jnp.bfloat16)
    want, mutated = jax.jit(lambda v, x: jm.apply(v, x, train=True, mutable=["batch_stats"]))(
        variables, jnp.asarray(x, jnp.bfloat16))
    want = np.asarray(want, np.float32)
    got = m(torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    # bf16 convolutions, BN and einsums on both sides with fp32 sums in
    # other orders: 4 bf16 ulps at the largest |out|
    top = float(np.abs(want).max())
    np.testing.assert_allclose(_np(got), want, atol=4 * 2.0 ** (np.floor(np.log2(top)) - 7),
                               rtol=0)
    # the running stats the step leaves behind: fp32 batch statistics of
    # bf16 activations
    stats = _leaves(cga_variables(m)["batch_stats"])
    for k, w in _leaves(mutated["batch_stats"]).items():
        np.testing.assert_allclose(stats[k], w, rtol=2e-2, atol=2e-3, err_msg=k)


def _name_bridge(model, depths, num_heads) -> dict[str, str]:
    """JAX param path -> port param name: a unique value per param, carried
    to the JAX layout by `convert_efficientvit`, names each leaf."""
    names = list(dict(model.named_parameters()))
    ids = {k: torch.full_like(p, float(i)) for i, (k, p) in enumerate(model.named_parameters())}
    tree = _leaves(_jax_tree(model, ids, depths, num_heads)["params"])
    bridge = {path: names[int(v.flat[0])] for path, v in tree.items()}
    assert sorted(bridge.values()) == sorted(names)
    return bridge


def _golden_batch():
    rng = np.random.default_rng(INPUT_SEED)
    x = rng.standard_normal((GOLDEN_BATCH, 224, 224, 3)).astype(np.float32)
    labels = rng.integers(0, 1000, GOLDEN_BATCH)
    return x, np.eye(1000, dtype=np.float32)[labels]


def jax_m5_train_golden() -> dict:
    """One fp32 JAX train step of EfficientViT-M5 at B=8 on the seeded
    weights: loss, grad_norm and per-param grad norms, keyed by the port's
    param names."""
    port = create_model("efficientvit_m5", device="cpu")
    cfg = _CONFIGS["efficientvit_m5"]
    sd = seeded_state_dict(port, WEIGHT_SEED)
    variables = convert_efficientvit({k: v.numpy() for k, v in sd.items()},
                                     depths=cfg["depth"], num_heads=cfg["num_heads"])
    jm = jax_create_model("efficientvit_m5")
    x, y = _golden_batch()
    loss, grads = _jax_loss_and_grads(jm)(variables["params"], variables["batch_stats"],
                                          jnp.asarray(x), jnp.asarray(y))
    bridge = _name_bridge(port, cfg["depth"], cfg["num_heads"])
    norms = {bridge[path]: float(np.linalg.norm(g)) for path, g in _leaves(grads).items()}
    names = sorted(norms)
    return {"loss": np.float32(loss), "grad_norm": np.float32(optax.global_norm(grads)),
            "names": np.asarray(names),
            "grad_norms": np.asarray([norms[n] for n in names], np.float32),
            "input_seed": np.int64(INPUT_SEED), "weight_seed": np.int64(WEIGHT_SEED)}


@pytest.mark.parametrize("route", DW_KERNELS)
def test_full_width_m5_train_step_matches_jax_golden(route):
    g = np.load(GOLDEN)
    assert int(g["input_seed"]) == INPUT_SEED and int(g["weight_seed"]) == WEIGHT_SEED
    m = create_model("efficientvit_m5", device="cpu", dw_kernel=route)
    m.load_state_dict(seeded_state_dict(m, WEIGHT_SEED))
    x, y = _golden_batch()
    loss, _, grads = loss_and_grads(m, {"image": torch.from_numpy(x),
                                        "label": torch.from_numpy(y)},
                                    losses.soft_target_ce)
    assert sorted(grads) == list(g["names"])
    # fp32 through the full depth and back, sums in other orders (measured
    # 2e-7 and 1e-5)
    np.testing.assert_allclose(float(loss), float(g["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(optim.global_norm(grads.values())),
                               float(g["grad_norm"]), rtol=1e-4)
    got = np.asarray([float(grads[n].norm()) for n in g["names"]])
    # per tensor 5e-3: ReLU inputs within fp32 noise of 0 make this step's
    # grads of the attention's BNs and of the first layers move by up to
    # ~1e-3 under fp32 rounding alone (the port in fp32 against the port in
    # fp64 differs by up to 7.6e-4 per tensor, the port against JAX by up to
    # 1.8e-3); grads that are zero up to float noise at the noise floor
    np.testing.assert_allclose(got, g["grad_norms"], rtol=5e-3,
                               atol=1e-7 * float(g["grad_norm"]))


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    GOLDEN.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(GOLDEN, **jax_m5_train_golden())
    print(f"wrote {GOLDEN}")
