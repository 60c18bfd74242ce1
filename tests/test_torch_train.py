"""cream_tpu_torch's training pieces vs the JAX package's, in fp32 on the CPU.

The centre is a 3-step train-step parity run of a narrow TinyViT: seeded
weights bridged by `convert_tinyvit`, one-hot batches from numpy, AdamW on a
warmup + cosine schedule with clipping and an EMA on both sides; drop path
and dropout are off, since JAX's random bits cannot be matched. Around it:
the optimizer, schedules, clipping, losses, mixup, drop path / dropout,
checkpoints, the synthetic dataset, and the full-width TinyViT-21M-224 train
step held to the stored JAX golden.

Regenerate the golden file (one fp32 JAX train step of TinyViT-21M-224 at
B=2 on the seeded weights) with
    python tests/test_torch_train.py
"""
import copy
import functools
from pathlib import Path

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from cream_tpu.models import create_model as jax_create_model
from cream_tpu.models.tinyvit import TinyViT as JaxTinyViT
from cream_tpu.train import TrainState as JaxTrainState
from cream_tpu.train import losses as jax_losses
from cream_tpu.train import make_train_step as jax_make_train_step
from cream_tpu.train import optim as jax_optim
from cream_tpu.train.metrics import topk_accuracy_counts as jax_topk_counts
from cream_tpu.zoo.import_torch import convert_tinyvit
from cream_tpu_torch.core import checkpoint
from cream_tpu_torch.data import mixup
from cream_tpu_torch.data.imagenet import (SyntheticDataset, eval_loader,
                                           prefetch, train_loader)
from cream_tpu_torch.models import create_model
from cream_tpu_torch.models.tinyvit import TinyViT
from cream_tpu_torch.ops.common import drop_path, dropout
from cream_tpu_torch.train import losses, optim
from cream_tpu_torch.train.metrics import topk_accuracy_counts
from cream_tpu_torch.train.state import TrainState
from cream_tpu_torch.train.steps import (loss_and_grads, make_eval_step,
                                         make_train_step, step_generator)
from cream_tpu_torch.zoo.load import seeded_state_dict
from torch_threads import one_torch_thread_module  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "data" / "torch_port" / "tinyvit_21m_224_train_seed0.npz"
WEIGHT_SEED, INPUT_SEED = 0, 1

NARROW = dict(embed_dims=(32, 32, 64, 64), depths=(1, 2, 1, 1),
              num_heads=(1, 1, 2, 2), window_sizes=(7, 7, 14, 7), num_classes=10)
IMG, BATCH = 112, 4       # stage 3 is 4x4: BN sees 64 samples there
LR = dict(base_lr=1e-3, warmup_steps=1, total_steps=5, warmup_init_lr=1e-4,
          min_lr=1e-5)


def _np(t):
    """A numpy copy (a view would follow the port's in-place updates)."""
    return t.detach().cpu().numpy().copy()


def _np_sd(sd):
    return {k: _np(v) for k, v in sd.items()}


def _leaves(tree) -> dict[str, np.ndarray]:
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in flat}


def _jax_tree(model, tensors: dict, depths) -> dict:
    """Port tensors keyed by param name (params, grads, EMA), with the
    model's buffers, in the JAX package's variable layout."""
    buffers = {k: _np(v) for k, v in model.state_dict().items()
               if k not in dict(model.named_parameters())}
    return convert_tinyvit({**buffers, **_np_sd(tensors)}, depths=depths)


def _batch(seed, batch=BATCH, img=IMG, num_classes=10):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, img, img, 3)).astype(np.float32)
    labels = rng.integers(0, num_classes, batch)
    return x, np.eye(num_classes, dtype=np.float32)[labels], labels


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(jm, loss_fn):
    """value_and_grad of `loss_fn` over `jm`'s train-mode forward, jitted
    once per (module, loss): the state and the batch are its arguments, so
    a multi-step test compiles it once."""
    def f(p, batch_stats, x, y):
        logits, _ = jm.apply({"params": p, "batch_stats": batch_stats}, x,
                             train=True, mutable=["batch_stats"])
        return loss_fn(logits, y)
    return jax.jit(jax.value_and_grad(f))


def _jax_loss_and_grads(jm, params, batch_stats, x, y, loss_fn):
    """The JAX train step's loss and raw grads at (params, batch_stats)."""
    return _jax_value_and_grad(jm, loss_fn)(params, batch_stats, x, y)


def _narrow_pair():
    m = TinyViT(img_size=IMG, device="cpu", drop_path_rate=0.0, **NARROW)
    m.load_state_dict(seeded_state_dict(m, 5))
    variables = convert_tinyvit(_np_sd(m.state_dict()), depths=NARROW["depths"])
    return m, JaxTinyViT(drop_path_rate=0.0, **NARROW), variables


def test_narrow_tinyvit_three_train_steps_match_jax():
    m, jm, variables = _narrow_pair()
    depths = NARROW["depths"]
    ema = 0.9
    jtx = jax_optim.make_adamw(jax_optim.cosine_schedule(*LR.values()),
                               weight_decay=0.05, clip_grad=5.0,
                               params=variables["params"])
    jstate = JaxTrainState.create(params=variables["params"], tx=jtx,
                                  batch_stats=variables["batch_stats"],
                                  ema_decay=ema)
    jstep = jax_make_train_step(jm, loss_fn=jax_losses.soft_target_ce, donate=False)
    tx = optim.make_adamw(optim.cosine_schedule(*LR.values()), weight_decay=0.05,
                          clip_grad=5.0, params=dict(m.named_parameters()))
    state = TrainState(m, tx, ema_decay=ema)
    step = make_train_step(loss_fn=losses.soft_target_ce)
    lrs = []
    for i in range(3):
        x, y, _ = _batch(10 + i)
        # raw grads at the pre-step state, on both sides (a copy of the port
        # model, so its BN running stats update only in the step itself)
        _, _, grads = loss_and_grads(copy.deepcopy(m), {
            "image": torch.from_numpy(x), "label": torch.from_numpy(y)},
            losses.soft_target_ce)
        _, jgrads = _jax_loss_and_grads(jm, jstate.params, jstate.batch_stats,
                                        jnp.asarray(x), jnp.asarray(y),
                                        jax_losses.soft_target_ce)
        lrs.append(state.tx.lr())
        state, metrics = step(state, {"image": torch.from_numpy(x),
                                      "label": torch.from_numpy(y)})
        jstate, jmetrics = jstep(jstate, {"image": jnp.asarray(x),
                                          "label": jnp.asarray(y)}, jax.random.key(0))
        assert set(metrics) == set(jmetrics) == {"loss", "grad_norm"}
        np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(metrics["grad_norm"]),
                                   float(jmetrics["grad_norm"]), rtol=1e-5)
        assert float(metrics["grad_norm"]) > 5.0         # the clip is active
        got = _leaves(_jax_tree(m, grads, depths)["params"])
        want = _leaves(jgrads)
        assert set(got) == set(want)
        # relative L2 1e-4; grads that are zero up to float noise (a bias
        # right before a train-mode BN: the last fc2 bias of a stage that
        # ends in a PatchMerging)
        # compare at the noise floor, 1e-7 of the global grad norm
        floor = 1e-7 * float(jmetrics["grad_norm"])
        for k in want:
            err = np.linalg.norm(got[k] - want[k])
            assert err <= 1e-4 * np.linalg.norm(want[k]) + floor, (k, err)
        if i == 0:
            # BN running stats after one step, while the params still agree:
            # a biased/unbiased variance mix-up would be a 0.16% gap here
            stats = _leaves(_jax_tree(m, state.params, depths)["batch_stats"])
            for k, w in _leaves(jstate.batch_stats).items():
                np.testing.assert_allclose(stats[k], w, rtol=1e-5, atol=1e-7, err_msg=k)
    # Adam's first update is ~lr*sign(g): an element whose grad sits at
    # float noise can move by up to 2*lr in either direction, so the params
    # and the EMA are held to 2*(sum of the step lrs)
    tol = 2 * sum(lrs)
    got = _jax_tree(m, state.params, depths)
    for k, w in _leaves(jstate.params).items():
        np.testing.assert_allclose(_leaves(got["params"])[k], w, atol=tol, rtol=0,
                                   err_msg=k)
    # the stats of steps 2-3 come from those params: within tol of their scale
    for k, w in _leaves(jstate.batch_stats).items():
        np.testing.assert_allclose(_leaves(got["batch_stats"])[k], w,
                                   atol=tol * np.abs(w).max(), rtol=0, err_msg=k)
    got_ema = _leaves(_jax_tree(m, state.ema_params, depths)["params"])
    for k, w in _leaves(jstate.ema_params).items():
        np.testing.assert_allclose(got_ema[k], w, atol=tol, rtol=0, err_msg=k)
    assert state.step == int(jstate.step) == 3


def test_int_label_step_metrics_match_jax():
    m, jm, variables = _narrow_pair()
    jstate = JaxTrainState.create(params=variables["params"],
                                  tx=optax.adamw(1e-3, weight_decay=0.05),
                                  batch_stats=variables["batch_stats"])
    state = TrainState(m, optim.make_adamw(1e-3, weight_decay=0.05, clip_grad=None))
    x, _, labels = _batch(20, batch=8)
    _, metrics = make_train_step()(state, {"image": torch.from_numpy(x),
                                           "label": torch.from_numpy(labels)})
    _, jmetrics = jax_make_train_step(jm, donate=False)(
        jstate, {"image": jnp.asarray(x), "label": jnp.asarray(labels)},
        jax.random.key(0))
    assert set(metrics) == set(jmetrics) == {"loss", "accuracy", "grad_norm"}
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-5)


def test_eval_step_counts_match_jax():
    m, jm, variables = _narrow_pair()
    x, _, labels = _batch(21, batch=6)
    labels[-2:] = -1                                  # padding
    state = TrainState(m, optim.make_adamw(1e-3))
    got = make_eval_step()(state, {"image": torch.from_numpy(x),
                                   "label": torch.from_numpy(labels)})
    from cream_tpu.train import make_eval_step as jax_make_eval_step
    jstate = JaxTrainState.create(params=variables["params"], tx=optax.sgd(0.1),
                                  batch_stats=variables["batch_stats"])
    want = jax_make_eval_step(jm)(jstate, {"image": jnp.asarray(x),
                                           "label": jnp.asarray(labels)})
    for k in ("correct1", "correct5", "n"):
        assert int(got[k]) == int(want[k]), k
    np.testing.assert_allclose(float(got["loss_sum"]), float(want["loss_sum"]), rtol=1e-5)
    assert topk_accuracy_counts([got]) == pytest.approx(jax_topk_counts([want]))


def _name_bridge(model, depths) -> dict[str, str]:
    """JAX param path -> port param name: a unique value per param, carried
    to the JAX layout by `convert_tinyvit`, names each leaf."""
    names = list(dict(model.named_parameters()))
    ids = {k: torch.full_like(p, float(i)) for i, (k, p) in
           enumerate(model.named_parameters())}
    tree = _leaves(_jax_tree(model, ids, depths)["params"])
    bridge = {path: names[int(v.flat[0])] for path, v in tree.items()}
    assert sorted(bridge.values()) == sorted(names)
    return bridge


def test_weight_decay_mask_matches_jax_name_by_name():
    m = create_model("tiny_vit_21m_224", device="cpu")
    bridge = _name_bridge(m, (2, 2, 6, 2))
    params = dict(m.named_parameters())
    jparams = convert_tinyvit(_np_sd(m.state_dict()))["params"]
    want = _leaves(jax_optim.weight_decay_mask(jparams))
    got = optim.weight_decay_mask(params)
    assert {bridge[p]: bool(v) for p, v in want.items()} == got
    assert 0 < sum(got.values()) < len(got)


@pytest.mark.parametrize("warmup,total", [(3, 10), (0, 7)])
def test_cosine_schedule_matches_optax(warmup, total):
    got = optim.cosine_schedule(1e-3, warmup, total, 1e-6, 1e-5)
    want = jax_optim.cosine_schedule(1e-3, warmup, total, 1e-6, 1e-5)
    for count in range(total + 3):
        # optax evaluates in fp32 (resolution ~1e-10 at the 1e-3 peak)
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-6, atol=1e-9)
    assert got(0) == pytest.approx(1e-6 if warmup else 1e-3)


def test_cosine_schedule_needs_decay_steps():
    with pytest.raises(ValueError):
        optim.cosine_schedule(1e-3, 5, 5)


def test_step_schedule_matches_jax():
    got = optim.step_schedule(0.1, 3, 0.5, warmup_steps=2, warmup_init_lr=0.01)
    want = jax_optim.step_schedule(0.1, 3, 0.5, warmup_steps=2, warmup_init_lr=0.01)
    for count in range(12):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-6)


def _toy(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"layer.weight": (rng.standard_normal((4, 3)) * scale).astype(np.float32),
            "layer.bias": (rng.standard_normal(4) * scale).astype(np.float32),
            "norm.weight": (rng.standard_normal(3) * scale).astype(np.float32)}


@pytest.mark.parametrize("max_norm,scale", [
    (0.5, 1.0),        # clips
    (100.0, 1.0),      # does not
    (1e-5, 1e-4),      # clips a norm of ~3e-4, where a +1e-6 would show
])
def test_clip_by_global_norm_matches_optax(max_norm, scale):
    g = _toy(0, scale)
    got = optim.clip_by_global_norm({k: torch.from_numpy(v) for k, v in g.items()},
                                    max_norm)
    want, _ = optax.clip_by_global_norm(max_norm).update(
        {k: jnp.asarray(v) for k, v in g.items()}, optax.EmptyState())
    for k in g:
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]), rtol=1e-6, atol=0)
    if max_norm > 10:
        assert all(torch.equal(got[k], torch.from_numpy(g[k])) for k in g)


def _run_optimizer(tx, jtx, steps=3, every=1):
    params = {k: torch.from_numpy(v) for k, v in _toy(1).items()}
    jparams = {k: jnp.asarray(v) for k, v in _toy(1).items()}
    jopt = jtx.init(jparams)
    for i in range(steps * every):
        g = _toy(100 + i)
        tx.step(params, {k: torch.from_numpy(v) for k, v in g.items()})
        upd, jopt = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, jopt, jparams)
        jparams = optax.apply_updates(jparams, upd)
    for k in params:
        np.testing.assert_allclose(_np(params[k]), np.asarray(jparams[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)


def test_adamw_matches_optax_with_mask_clip_and_schedule():
    sched = optim.cosine_schedule(1e-2, 1, 4, 1e-3, 1e-4)
    jsched = jax_optim.cosine_schedule(1e-2, 1, 4, 1e-3, 1e-4)
    p = {k: torch.from_numpy(v) for k, v in _toy(1).items()}
    tx = optim.make_adamw(sched, weight_decay=0.1, clip_grad=1.0, params=p)
    assert tx.mask == {"layer.weight": True, "layer.bias": False, "norm.weight": False}
    jtx = jax_optim.make_adamw(jsched, weight_decay=0.1, clip_grad=1.0,
                               params={k: jnp.asarray(v) for k, v in _toy(1).items()})
    _run_optimizer(tx, jtx)


def test_sgd_and_layer_scales_match_optax():
    _run_optimizer(optim.make_sgd(0.1, momentum=0.9, weight_decay=0.01, nesterov=True),
                   jax_optim.make_sgd(0.1, momentum=0.9, weight_decay=0.01,
                                      nesterov=True))
    block = lambda name: 0 if name.startswith("layer") else None
    scales = optim.layer_lr_scales(_toy(1), 2, block, 0.5)
    assert scales == {"layer.weight": 0.5, "layer.bias": 0.5, "norm.weight": 1.0}
    jscales = jax_optim.layer_lr_scales({k: jnp.asarray(v) for k, v in _toy(1).items()},
                                        2, block, 0.5)
    _run_optimizer(optim.make_adamw(1e-2, clip_grad=None, layer_scales=scales),
                   jax_optim.make_adamw(1e-2, clip_grad=None, layer_scales=jscales))


def test_multisteps_matches_optax():
    _run_optimizer(optim.MultiSteps(optim.make_adamw(1e-2, clip_grad=1.0), 2),
                   optax.MultiSteps(jax_optim.make_adamw(1e-2, clip_grad=1.0), 2),
                   steps=2, every=2)


def test_ema_and_state_round_trip(tmp_path):
    m = TinyViT(img_size=64, device="cpu", **NARROW)
    m.load_state_dict(seeded_state_dict(m, 1))
    state = TrainState(m, optim.make_adamw(1e-2), ema_decay=0.5)
    before = {k: v.clone() for k, v in state.params.items()}
    x, y, _ = _batch(30, batch=2, img=64)
    gen_step = make_train_step(loss_fn=losses.soft_target_ce)
    gen_step(state, {"image": torch.from_numpy(x), "label": torch.from_numpy(y)})
    for k, p in state.params.items():      # e = 0.5*e + 0.5*p after the update
        torch.testing.assert_close(state.ema_params[k], 0.5 * before[k] + 0.5 * p.detach())
    assert set(state.ema_params) == set(state.params)     # params only, no BN buffers

    ckpt = str(tmp_path / "ckpt")
    assert checkpoint.latest_step(ckpt) is None
    with checkpoint.AsyncCheckpointer(ckpt, max_to_keep=2) as ck:
        for s in (1, 2, 3):
            ck.save(s, state, extra={"epoch": s})
    assert checkpoint.steps(ckpt) == [2, 3]
    m2 = TinyViT(img_size=64, device="cpu", **NARROW)
    fresh = TrainState(m2, optim.make_adamw(1e-2), ema_decay=0.5)
    restored, extra, step = checkpoint.restore_checkpoint(ckpt, fresh)
    assert step == 3 and extra == {"epoch": 3} and restored.step == 1
    sd, sd2 = state.state_dict(), restored.state_dict()
    assert all(torch.equal(sd["model"][k], sd2["model"][k]) for k in sd["model"])
    assert all(torch.equal(state.ema_params[k], restored.ema_params[k])
               for k in state.ema_params)
    assert restored.tx.count == state.tx.count == 1
    params = checkpoint.restore_params(ckpt)
    assert all(torch.equal(params[k], v) for k, v in state.params.items())
    with pytest.raises(FileNotFoundError):
        checkpoint.restore_checkpoint(str(tmp_path / "none"), fresh)


def test_drop_path_and_dropout_rates_and_scaling():
    x = torch.ones(4000, 8)
    for fn, rate in ((drop_path, 0.25), (dropout, 0.4)):
        gen = lambda: torch.Generator().manual_seed(7)
        y = fn(x, rate, False, gen())
        assert torch.equal(y, fn(x, rate, False, gen()))        # seeded
        assert fn(x, rate, True, gen()) is x                     # eval: identity
        kept = y != 0
        # kept values scaled by 1/(1-rate); the keep rate within 4 sigma
        assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / (1 - rate)))
        frac = kept.float().mean().item()
        n = x.shape[0] if fn is drop_path else x.numel()
        assert abs(frac - (1 - rate)) < 4 * (rate * (1 - rate) / n) ** 0.5
        if fn is drop_path:                  # per sample: whole rows
            assert ((kept.all(1)) | (~kept.any(1))).all()
    with pytest.raises(ValueError):
        dropout(x, 0.1, False)
    assert not dropout(x, 1.0, False, torch.Generator()).any()


def test_tinyvit_drop_path_schedule_and_train_mode():
    m = create_model("tiny_vit_21m_224", device="cpu")
    rates = [b.drop_path_rate for layer in m.layers for b in layer.blocks]
    want = [0.2 * i / 11 for i in range(12)]        # linear over all 12 blocks
    np.testing.assert_allclose(rates, want)
    small = TinyViT(img_size=64, device="cpu", drop_path_rate=0.5, drop_rate=0.1,
                    **NARROW).train()
    x = torch.from_numpy(_batch(31, batch=4, img=64)[0])
    with pytest.raises(ValueError):                 # train mode draws need a generator
        small(x)
    a = small(x, torch.Generator().manual_seed(3))
    assert torch.equal(a, small(x, torch.Generator().manual_seed(3)))
    assert not torch.equal(a, small(x, torch.Generator().manual_seed(4)))


def test_step_generator_is_a_function_of_seed_and_step():
    draw = lambda s, t: torch.rand(4, generator=step_generator(s, t, "cpu"))
    assert torch.equal(draw(0, 5), draw(0, 5))
    assert not torch.equal(draw(0, 5), draw(0, 6))
    assert not torch.equal(draw(0, 5), draw(1, 5))


def test_losses_match_jax():
    rng = np.random.default_rng(40)
    a = rng.standard_normal((6, 12)).astype(np.float32)
    b = rng.standard_normal((6, 12)).astype(np.float32)
    p = np.exp(b) / np.exp(b).sum(-1, keepdims=True)
    labels = rng.integers(0, 12, 6)
    t, j = torch.from_numpy, jnp.asarray
    pairs = [
        (losses.label_smoothing_ce(t(a), t(labels), 0.1),
         jax_losses.label_smoothing_ce(j(a), j(labels), 0.1)),
        (losses.soft_target_ce(t(a), t(p)), jax_losses.soft_target_ce(j(a), j(p))),
        (losses.kl_divergence(t(a), t(b), 2.0), jax_losses.kl_divergence(j(a), j(b), 2.0)),
        (losses.interactive_loss(t(a), t(b), "cos"),
         jax_losses.interactive_loss(j(a), j(b), "cos")),
        (losses.interactive_loss(t(a), t(b), "mse"),
         jax_losses.interactive_loss(j(a), j(b), "mse")),
    ]
    for kind in ("none", "soft", "hard"):
        pairs.append((losses.deit_distillation_loss(t(a[0, :1]), t(a), t(b), kind, 0.3, 2.0),
                      jax_losses.deit_distillation_loss(j(a[0, :1]), j(a), j(b), kind,
                                                        0.3, 2.0)))
    vals = np.sort(p, -1)[:, ::-1][:, :4].copy()
    idx = np.argsort(-p, -1)[:, :4].copy()
    pairs.append((losses.dense_from_topk(t(vals), t(idx), 12),
                  jax_losses.dense_from_topk(j(vals), j(idx), 12)))
    qkv_s = rng.standard_normal((3, 2, 4, 5, 8)).astype(np.float32)
    qkv_t = rng.standard_normal((3, 2, 4, 5, 8)).astype(np.float32)
    pairs.append((losses.relation_distillation_loss(t(qkv_s), t(qkv_t), 2, 1.5),
                  jax_losses.relation_distillation_loss(j(qkv_s), j(qkv_t), 2, 1.5)))
    pairs.append((losses.hidden_relation_loss(t(qkv_s[0, 0]), t(qkv_t[0, 0])),
                  jax_losses.hidden_relation_loss(j(qkv_s[0, 0]), j(qkv_t[0, 0]))))
    for got, want in pairs:
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_mixup_with_both_alphas_zero_matches_jax():
    from cream_tpu.data.mixup import mixup_cutmix as jax_mixup
    rng = np.random.default_rng(50)
    x = rng.standard_normal((4, 8, 8, 3)).astype(np.float32)
    labels = np.array([1, 3, 0, 3])
    got = mixup.mixup_cutmix(torch.Generator().manual_seed(0), torch.from_numpy(x),
                             torch.from_numpy(labels), 5, 0.0, 0.0, 0.5, 0.1)
    want = jax_mixup(jax.random.key(0), jnp.asarray(x), jnp.asarray(labels), 5,
                     0.0, 0.0, 0.5, 0.1)
    np.testing.assert_array_equal(_np(got[0]), np.asarray(want[0]))
    np.testing.assert_allclose(_np(got[1]), np.asarray(want[1]), rtol=1e-6)


@pytest.mark.parametrize("mix,cut", [(0.8, 1.0), (0.8, 0.0), (0.0, 1.0)])
def test_mixup_cutmix_invariants(mix, cut):
    rng = np.random.default_rng(51)
    x = torch.from_numpy(rng.standard_normal((6, 16, 16, 3)).astype(np.float32))
    labels = torch.tensor([0, 1, 2, 3, 4, 5])
    flipped = x.flip(0)
    on, off = 1 - 0.1 + 0.01, 0.01                     # smoothing 0.1, 10 classes
    modes = set()
    for seed in range(8):
        imgs, tg = mixup.mixup_cutmix(torch.Generator().manual_seed(seed), x, labels,
                                      10, mix, cut, 0.5, 0.1)
        torch.testing.assert_close(tg.sum(-1), torch.ones(6))     # targets sum to 1
        lam = (tg[0, 0].item() - off) / (on - off)      # example 0's own share
        torch.testing.assert_close(tg, mixup.smooth_one_hot(labels, 10, 0.1) * lam
                                   + mixup.smooth_one_hot(labels.flip(0), 10, 0.1) * (1 - lam))
        if ((imgs == x) | (imgs == flipped)).all():
            # cutmix: whole pixels from one of the pair; the partner's box
            # area is the partner's target share
            modes.add("cut")
            own = (imgs == x).all(-1).float().mean((1, 2))
            torch.testing.assert_close(own, torch.full((6,), lam), atol=1e-6, rtol=0)
        else:
            # mixup: every pixel the same convex blend of the pair
            modes.add("mix")
            assert 0.0 <= lam <= 1.0
            torch.testing.assert_close(imgs, x * lam + flipped * (1 - lam),
                                       atol=1e-5, rtol=0)
    assert modes == {m for m, a in (("mix", mix), ("cut", cut)) if a > 0}


def test_mix_batch_given_lam_and_box_is_the_jax_formula():
    rng = np.random.default_rng(52)
    x = rng.standard_normal((4, 6, 6, 3)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[[0, 1, 2, 3]]
    imgs, tg = mixup.mix_batch(torch.from_numpy(x), torch.from_numpy(y), 0.3)
    np.testing.assert_allclose(_np(imgs), x * 0.3 + x[::-1] * 0.7, rtol=1e-6)
    np.testing.assert_allclose(_np(tg), y * 0.3 + y[::-1] * 0.7, rtol=1e-6)
    box = (1, 4, 2, 6)
    imgs, _ = mixup.mix_batch(torch.from_numpy(x), torch.from_numpy(y), 0.5, box)
    mask = np.zeros((6, 6), bool)
    mask[1:4, 2:6] = True
    np.testing.assert_array_equal(_np(imgs), np.where(mask[None, :, :, None], x[::-1], x))
    (y0, y1, x0, x1), lam = mixup.cutmix_box(torch.Generator().manual_seed(3), 20, 30, 0.6)
    assert 0 <= y0 <= y1 <= 20 and 0 <= x0 <= x1 <= 30
    assert lam == pytest.approx(1 - (y1 - y0) * (x1 - x0) / 600)


def test_seeded_pair_mixup_replays():
    rng = np.random.default_rng(53)
    x = torch.from_numpy(rng.standard_normal((6, 8, 8, 3)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 5, 6))
    seeds = rng.integers(0, 2 ** 31, 6)
    a = mixup.seeded_pair_mixup(seeds, x, labels, 5)
    b = mixup.seeded_pair_mixup(seeds, x, labels, 5)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    torch.testing.assert_close(a[1].sum(-1), torch.ones(6))
    pairs = x.reshape(3, 2, 8, 8, 3)
    for i in range(3):          # every pixel is a blend within its own pair
        got, p, q = a[0][2 * i], pairs[i, 0], pairs[i, 1]
        assert (((got - p).abs() < 1e-5) | ((got - q).abs() < 1e-5)).all() or \
            torch.allclose(got + a[0][2 * i + 1], p + q, atol=1e-5)


def test_synthetic_dataset_matches_jax():
    from cream_tpu.data.imagenet import SyntheticDataset as JaxSynthetic
    ds, jds = SyntheticDataset(8, 32, 10), JaxSynthetic(8, 32, 10)
    for i in range(8):
        img, label = ds.load(i)
        jimg, jlabel = jds.load(i)
        np.testing.assert_array_equal(img, np.asarray(jimg))
        assert label == jlabel
    # the loaders give the JAX loaders' batches: the seeded random resized
    # crop + flip of the train loader, the eval resize + crop, bit for bit
    from cream_tpu.data.imagenet import eval_loader as jax_eval_loader
    from cream_tpu.data.imagenet import train_loader as jax_train_loader
    batches = list(prefetch(train_loader(ds, 3, epoch=1, img_size=32, num_workers=2)))
    assert len(batches) == 2 and batches[0]["image"].shape == (3, 32, 32, 3)
    order = np.random.default_rng(1).permutation(8)
    np.testing.assert_array_equal(np.concatenate([b["index"] for b in batches]), order[:6])
    want = list(jax_train_loader(jds, 3, epoch=1, img_size=32, num_workers=2))
    for got, w in zip(batches, want):
        np.testing.assert_array_equal(got["image"], w["image"])
    ev = list(eval_loader(ds, 3, img_size=32, num_workers=2))
    assert [len(b["label"]) for b in ev] == [3, 3, 3]
    np.testing.assert_array_equal(ev[-1]["label"][-1:], [-1])
    for got, w in zip(ev, jax_eval_loader(jds, 3, img_size=32, num_workers=2)):
        np.testing.assert_array_equal(got["image"], w["image"])


def _golden_batch():
    rng = np.random.default_rng(INPUT_SEED)
    x = rng.standard_normal((2, 224, 224, 3)).astype(np.float32)
    labels = rng.integers(0, 1000, 2)
    return x, np.eye(1000, dtype=np.float32)[labels]


def jax_tinyvit21m_train_golden() -> dict:
    """One fp32 JAX train step of TinyViT-21M-224 (drop path 0) on the
    seeded weights: loss, grad_norm and per-param grad norms, keyed by the
    port's param names."""
    port = create_model("tiny_vit_21m_224", device="cpu")
    variables = convert_tinyvit(_np_sd(seeded_state_dict(port, WEIGHT_SEED)))
    jm = jax_create_model("tiny_vit_21m_224", drop_path_rate=0.0)
    x, y = _golden_batch()
    loss, grads = _jax_loss_and_grads(jm, variables["params"],
                                      variables["batch_stats"], jnp.asarray(x),
                                      jnp.asarray(y), jax_losses.soft_target_ce)
    bridge = _name_bridge(port, (2, 2, 6, 2))
    norms = {bridge[path]: float(np.linalg.norm(g)) for path, g in _leaves(grads).items()}
    names = sorted(norms)
    return {"loss": np.float32(loss), "grad_norm": np.float32(optax.global_norm(grads)),
            "names": np.asarray(names), "grad_norms": np.asarray(
                [norms[n] for n in names], np.float32),
            "input_seed": np.int64(INPUT_SEED), "weight_seed": np.int64(WEIGHT_SEED)}


def test_full_width_21m_train_step_matches_jax_golden():
    g = np.load(GOLDEN)
    assert int(g["input_seed"]) == INPUT_SEED and int(g["weight_seed"]) == WEIGHT_SEED
    m = create_model("tiny_vit_21m_224", device="cpu", drop_path_rate=0.0)
    m.load_state_dict(seeded_state_dict(m, WEIGHT_SEED))
    x, y = _golden_batch()
    loss, _, grads = loss_and_grads(m, {"image": torch.from_numpy(x),
                                        "label": torch.from_numpy(y)},
                                    losses.soft_target_ce)
    assert sorted(grads) == list(g["names"])
    # fp32 through the full depth and back, sums in other orders
    np.testing.assert_allclose(float(loss), float(g["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(optim.global_norm(grads.values())),
                               float(g["grad_norm"]), rtol=1e-4)
    got = np.asarray([float(grads[n].norm()) for n in g["names"]])
    # per tensor 1e-3; grads that are zero up to float noise (the last fc2
    # bias of stages 1 and 2, before PatchMerging's train-mode BN) at the
    # noise floor
    np.testing.assert_allclose(got, g["grad_norms"], rtol=1e-3,
                               atol=1e-7 * float(g["grad_norm"]))


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    GOLDEN.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(GOLDEN, **jax_tinyvit21m_train_golden())
    print(f"wrote {GOLDEN}")
