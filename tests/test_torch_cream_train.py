"""cream_tpu_torch's Cream train step and meta step against the JAX
package's: `nas.cream.make_cream_train_step` on a one-stage, 2-layer
supernet and `make_meta_update_step` on a 1-layer one, at 32² (JAX
compiles all six choices of every layer, and the meta step's second order
through them, so the depth sets these tests' time); shared seeded weights,
numpy-seeded inputs; and the JAX-side faults this slice found (its step
moves the BN statistics of the choices it did not pick; its meta step moves
the statistics too). Helpers: `test_torch_cream_nas.py`.
"""
import copy
import functools

import numpy as np
import optax
import pytest
import torch

import jax.numpy as jnp

from cream_tpu.models import cream as JC
from cream_tpu.nas import cream as jax_nas
from cream_tpu.train import TrainState as JaxTrainState
from cream_tpu_torch.models import cream as C
from cream_tpu_torch.nas import cream as nas
from cream_tpu_torch.train.optim import make_sgd
from cream_tpu_torch.train.state import TrainState
from cream_tpu_torch.zoo.load import seeded_state_dict

from test_torch_cream_nas import _np, _supernet, supernet_to_jax
from test_torch_train import _leaves
from torch_threads import one_torch_thread_module  # noqa: F401

TRAIN_STAGES = ((16, 2, 2),)
TRAIN_ARCHS = [[5, -1], [5, 3], [1, 0]]
META_STAGES = ((16, 1, 2),)
META_ARCHS = ([1], [5])          # (student, teacher)


def _batch(seed, batch=8, img=32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, img, img, 3)).astype(np.float32),
            rng.integers(0, 10, batch))


def _train_supernet(seed=3, stages=TRAIN_STAGES):
    return _supernet(seed, stages=stages, img=32)


def _layers(arch, stages=TRAIN_STAGES):
    li = 0
    for s, (_, d, _) in enumerate(stages):
        for i in range(d):
            yield s, i, arch[li]
            li += 1


@functools.lru_cache(maxsize=None)
def _two_steps():
    """2 steps of `make_cream_train_step` on both sides (SGD 0.05 / 0.9):
    plain CE on path A (a skipped layer), then meta-weighted KD + CE of path
    B against teacher path A. Returns the BN statistics before, the losses,
    both sides' statistics after step 1, and both sides' variables after
    step 2 (JAX compiles its step once for the two tests that read them)."""
    m, _ = _train_supernet()
    lr = 0.05
    variables = supernet_to_jax(m.state_dict(), TRAIN_STAGES)
    before = _leaves(variables["batch_stats"])
    jstate = JaxTrainState.create(params=variables["params"], tx=optax.sgd(lr, momentum=0.9),
                                  batch_stats=variables["batch_stats"])
    jstep = jax_nas.make_cream_train_step(JC.CreamSupernet(num_classes=10, stages=TRAIN_STAGES),
                                          optax.sgd(lr, momentum=0.9))
    state = TrainState(m, make_sgd(lr, momentum=0.9))
    step = nas.make_cream_train_step()
    a, b = TRAIN_ARCHS[0], TRAIN_ARCHS[1]
    losses, after1 = [], None
    for i, (s_arch, t_arch, mv, kd) in enumerate([(a, a, 0.0, False), (b, a, 0.7, True)]):
        x, y = _batch(20 + i)
        state, metrics = step(state, {"image": torch.from_numpy(x), "label": torch.from_numpy(y)},
                              s_arch, t_arch, mv, kd)
        jstate, jmetrics = jstep(jstate, {"image": jnp.asarray(x), "label": jnp.asarray(y)},
                                 jnp.asarray(s_arch), jnp.asarray(t_arch), jnp.float32(mv),
                                 jnp.bool_(kd))
        losses.append((float(metrics["loss"]), float(jmetrics["loss"])))
        if i == 0:
            after1 = (_leaves(supernet_to_jax(m.state_dict(), TRAIN_STAGES)["batch_stats"]),
                      _leaves(jstate.batch_stats))
    final = (_leaves(supernet_to_jax(m.state_dict(), TRAIN_STAGES)), _leaves(jstate.params),
             _leaves(jstate.batch_stats))
    return before, losses, after1, final


def test_two_train_steps_match_jax():
    """`_two_steps` (teacher path A's choices' running statistics agree on
    both sides: A ran in step 1): loss within 1e-5, every param (those off
    the path moved by momentum alone) within 1e-5, and the statistics of
    the BNs both steps ran (the stem, the fixed blocks, the choices on both
    paths) within 1e-5 of JAX's."""
    _, losses, _, (got, want_params, want_stats) = _two_steps()
    for port, jx in losses:
        np.testing.assert_allclose(port, jx, rtol=1e-5)
    for k, w in want_params.items():
        assert np.abs(got[f"params/{k}"] - w).max() <= 1e-5, k
    a, b = TRAIN_ARCHS[0], TRAIN_ARCHS[1]
    both = {f"stage_{s}_layer_{i}/choice_{op}" for (s, i, op), (_, _, op2) in
            zip(_layers(a), _layers(b)) if op >= 0 and op == op2}
    assert both
    for k, w in want_stats.items():
        if not k.startswith("stage_") or "/".join(k.split("/")[:2]) in both:
            assert np.abs(got[f"batch_stats/{k}"] - w).max() <= 1e-5, k


def test_speed_test_times_the_supernet_through_its_step():
    """`speed_test.supernet_step` on a Cream supernet built at a fixed path
    is `make_cream_train_step` on that path without KD: the same loss,
    params and BN statistics after a step."""
    from cream_tpu_torch.cli import speed_test
    x, y = _batch(9)
    batch = {"image": torch.from_numpy(x), "label": torch.from_numpy(y)}
    models = []
    for _ in range(2):
        m, _ = _train_supernet()
        m.config = TRAIN_ARCHS[0]
        models.append(m)
    states = [TrainState(m, make_sgd(0.1, momentum=0.9)) for m in models]
    _, got = speed_test.supernet_step(models[0])(states[0], batch, 3)
    _, want = nas.make_cream_train_step()(states[1], batch, TRAIN_ARCHS[0], None, 0.0, False)
    assert float(got["loss"]) == float(want["loss"])
    a, b = models[0].state_dict(), models[1].state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_jax_moves_the_bn_statistics_of_unchosen_choices():
    """JAX's train step runs all six choices with train=True, so the
    running statistics of the five it did not pick move too; the port runs
    the chosen choice alone and leaves the others'. After `_two_steps`'
    first step (a path with a skipped layer): on JAX's side every unchosen
    choice's statistics moved (max-abs difference from the start > 1e-3),
    the skipped layer's included; on the port's none did (exactly equal);
    the chosen choices agree (1e-5)."""
    before, _, (got, want), _ = _two_steps()
    chosen = {f"stage_{s}_layer_{i}/choice_{op}" for s, i, op in _layers(TRAIN_ARCHS[0])
              if op >= 0}
    n_unchosen = 0
    for k in want:
        if not k.startswith("stage_"):
            continue
        if "/".join(k.split("/")[:2]) in chosen:
            assert np.abs(got[k] - want[k]).max() <= 1e-5, k
        else:
            n_unchosen += 1
            assert np.array_equal(got[k], before[k]), k
            assert np.abs(want[k] - before[k]).max() > 1e-3, k
    assert n_unchosen == 2 * 3 * (6 * 2 - 1)       # (mean, var) x 3 BNs x 11 choices


def test_meta_step_grads_match_jax():
    """The meta head's grads of the validation loss after one simulated
    SGD step on the meta-weighted KD loss (BN in eval mode, the statistics
    among the simulated weights) within 1e-5 of the largest of JAX's
    `make_meta_update_step`; the loss within 1e-5; the model unchanged."""
    m, jm = _train_supernet(stages=META_STAGES)
    sl = 4
    meta = C.MetaMatchingHead(sl * 10, device="cpu")
    meta.load_state_dict(seeded_state_dict(meta, 9))
    jmeta = JC.MetaMatchingHead()
    meta_params = {"fc1": {"kernel": _np(meta.fc1.weight).T, "bias": _np(meta.fc1.bias)},
                   "fc2": {"kernel": _np(meta.fc2.weight).T, "bias": _np(meta.fc2.bias)}}
    variables = supernet_to_jax(m.state_dict(), META_STAGES)
    x, y = _batch(40)
    s_arch, t_arch = META_ARCHS
    rng = np.random.default_rng(41)
    kd = rng.dirichlet(np.ones(10), sl).astype(np.float32)
    jloss, jg = jax_nas.make_meta_update_step(jm, jmeta, sgd_lr=0.5, slice_size=sl)(
        {"params": meta_params}, variables, jnp.asarray(x), jnp.asarray(y),
        jnp.asarray(s_arch), jnp.asarray(t_arch), jnp.asarray(kd))
    sd = copy.deepcopy(m.state_dict())
    loss, g = nas.make_meta_update_step(m, meta, sgd_lr=0.5, slice_size=sl)(
        torch.from_numpy(x), torch.from_numpy(y), s_arch, t_arch, torch.from_numpy(kd))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = {"fc1.weight": np.asarray(jg["params"]["fc1"]["kernel"]).T,
            "fc1.bias": np.asarray(jg["params"]["fc1"]["bias"]),
            "fc2.weight": np.asarray(jg["params"]["fc2"]["kernel"]).T,
            "fc2.bias": np.asarray(jg["params"]["fc2"]["bias"])}
    scale = max(np.abs(w).max() for w in want.values())
    assert scale > 0
    for k, w in want.items():
        assert np.abs(_np(g[k]) - w).max() <= 1e-5 * scale, k
    assert all(torch.equal(sd[k], v) for k, v in m.state_dict().items())


def test_meta_step_runs_through_the_bn_statistics():
    """JAX's simulated step moves the BN running statistics too (they are
    among `variables`): dropping them from the simulated weights changes the
    meta-grads, so the test above would see it."""
    m, _ = _train_supernet(stages=META_STAGES)
    sl = 4
    meta = C.MetaMatchingHead(sl * 10, device="cpu")
    meta.load_state_dict(seeded_state_dict(meta, 9))
    x, y = _batch(40)
    kd = torch.from_numpy(np.random.default_rng(41).dirichlet(np.ones(10), sl)
                          .astype(np.float32))
    args = (torch.from_numpy(x), torch.from_numpy(y), *META_ARCHS, kd)
    _, g = nas.make_meta_update_step(m, meta, 0.5, sl)(*args)
    real = nas.model_state
    try:
        nas.model_state = lambda model: dict(model.named_parameters())
        _, g2 = nas.make_meta_update_step(m, meta, 0.5, sl)(*args)
    finally:
        nas.model_state = real
    diff = (g["fc1.weight"] - g2["fc1.weight"]).abs().max() / g["fc1.weight"].abs().max()
    assert diff > 1e-3, float(diff)
