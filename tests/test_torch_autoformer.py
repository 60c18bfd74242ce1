"""cream_tpu_torch's AutoFormer (elastic layers, the supernet, its subnets,
the supernet train step, evolution search and the two CLIs) against the
JAX package's, on shared seeded weights and numpy-seeded inputs.

The port slices the super weights per config; JAX masks them at the super
widths. Weights: `seeded_state_dict` on the port's supernet, carried to JAX
by `cream_tpu.zoo.import_torch.convert_autoformer_supernet`; the port's
`zoo.load.autoformer_state_dict_from_jax` carries JAX's back. No TPU
kernel lies on this path.

Regenerate the golden files (JAX fp32 B=2 logits of autoformer_supernet_tiny
at three configs and one fp32 supernet train step) with
    PYTHONPATH=.:tests python tests/test_torch_autoformer.py
"""
import functools
import json
from pathlib import Path

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from cream_tpu.models import autoformer as JA
from cream_tpu.models import create_model as jax_create_model
from cream_tpu.nas import evolution as jax_evolution
from cream_tpu.nas.supernet_engine import make_supernet_train_step as jax_supernet_step
from cream_tpu.nn import elastic as jax_elastic
from cream_tpu.train import TrainState as JaxTrainState
from cream_tpu.train import optim as jax_optim
from cream_tpu.zoo.import_torch import convert_autoformer_supernet
from cream_tpu.zoo.load import load_model_variables
from cream_tpu_torch.cli import search_evolution, speed_test, supernet_train
from cream_tpu_torch.models import autoformer as A
from cream_tpu_torch.models import create_model, list_models
from cream_tpu_torch.nas import evolution
from cream_tpu_torch.nas.supernet_engine import make_supernet_train_step
from cream_tpu_torch.nn.elastic import ElasticLayerNorm, ElasticLinear
from cream_tpu_torch.train import optim
from cream_tpu_torch.train.state import TrainState
from cream_tpu_torch.train.steps import loss_and_grads
from cream_tpu_torch.zoo.load import autoformer_state_dict_from_jax, seeded_state_dict

from test_torch_train import _leaves

REPO = Path(__file__).resolve().parent.parent
DATA = REPO / "tests" / "data" / "torch_port"
GOLDEN = DATA / "autoformer_supernet_tiny_seed0.npz"
TRAIN_GOLDEN = DATA / "autoformer_supernet_tiny_train_seed0.npz"
NAME = "autoformer_supernet_tiny"
WEIGHT_SEED, INPUT_SEED = 0, 1
GOLDEN_CONFIGS = ("smallest", "largest", "seed:1")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread a test: the suite runs in several workers at once,
    and torch's default of a thread a core oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    """A numpy copy (a view would follow the port's in-place updates)."""
    return t.detach().cpu().numpy().copy()


def _np_sd(sd):
    return {k: _np(v) for k, v in sd.items()}


# ---- narrow space: heads 1-2 (super embed 128), 32² images, patch 8 ----

SPACE = dict(mlp_ratio=(1.5, 2.0), num_heads=(1, 2), depth=(1, 2, 3), embed_dim=(64, 96, 120))
SP, JSP = A.SearchSpace(**SPACE), JA.SearchSpace(**SPACE)
NARROW_CONFIGS = [A.fixed_config(SP, s) for s in ("smallest", "largest")] + \
    [A.sample_config(np.random.default_rng(s), SP) for s in (0, 1, 3, 7)]


def _supernet(dtype=torch.float32, seed=5):
    m = A.AutoFormerSuper(SP, num_classes=10, img_size=32, patch_size=8, drop_path_rate=0.0,
                          dtype=dtype, device="cpu")
    m.load_state_dict(seeded_state_dict(m, seed))
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    jm = JA.AutoFormerSuper(space=JSP, num_classes=10, patch_size=8, drop_path_rate=0.0,
                            dtype=jdt)
    return m.eval(), jm


def _enc(config, space=SP):
    return {k: jnp.asarray(v) for k, v in A.encode_config(config, space).items()}


def _images(seed=7, batch=2, size=32):
    return np.random.default_rng(seed).standard_normal((batch, size, size, 3)).astype(np.float32)


def test_elastic_layers_match_jax_with_zero_grads_outside():
    """ElasticLinear / ElasticLayerNorm at random actives against JAX's
    masked ElasticDense / ElasticLayerNorm: the active outputs within 1e-6
    (JAX's masked ones are 0), the grads of the active block within 1e-6
    and exactly 0 outside it, as JAX's masks give."""
    rng = np.random.default_rng(0)
    fc = ElasticLinear(48, 40, device="cpu")
    ln = ElasticLayerNorm(48, device="cpu")
    with torch.no_grad():
        for p in list(fc.parameters()) + list(ln.parameters()):
            p.copy_(torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32)))
    jfc = jax_elastic.ElasticDense(48, 40)
    jln = jax_elastic.ElasticLayerNorm(48)
    fc_vars = {"params": {"kernel": _np(fc.weight).T, "bias": _np(fc.bias)}}
    ln_vars = {"params": {"scale": _np(ln.weight), "bias": _np(ln.bias)}}
    for n_in, n_out in ((48, 40), (17, 9), (33, 40), (1, 1)):
        x = rng.standard_normal((3, 5, 48)).astype(np.float32)
        xt = torch.from_numpy(x[..., :n_in])
        y = ln(xt, torch.float32)
        out = fc(y, n_out, torch.float32)
        w_grad, ln_grad = torch.autograd.grad(out.square().sum(), [fc.weight, ln.weight])

        def f(pf, pl):
            h = jln.apply({"params": pl}, jnp.asarray(x), n_in)
            return jfc.apply({"params": pf}, h, n_in, n_out)
        want = np.asarray(f(fc_vars["params"], ln_vars["params"]))
        np.testing.assert_allclose(out.detach().numpy(), want[..., :n_out], atol=1e-5, rtol=1e-6)
        assert not want[..., n_out:].any()
        gf, gl = jax.grad(lambda pf, pl: jnp.sum(f(pf, pl) ** 2), argnums=(0, 1))(
            fc_vars["params"], ln_vars["params"])
        gk = np.asarray(gf["kernel"]).T
        np.testing.assert_allclose(w_grad[:n_out, :n_in].numpy(), gk[:n_out, :n_in],
                                   atol=1e-4, rtol=1e-5)
        assert not w_grad[n_out:].any() and not w_grad[:, n_in:].any()
        assert not gk[n_out:].any() and not gk[:, n_in:].any()
        np.testing.assert_allclose(ln_grad.numpy(), np.asarray(gl["scale"]), atol=1e-4, rtol=1e-5)
        assert not ln_grad[n_in:].any()


@pytest.mark.parametrize("space", sorted(A.SPACES))
def test_config_functions_equal_jax(space):
    """sample_config, encode_config, config_param_count and config_flops
    give JAX's values over 200 seeded configs of each space."""
    sp, jsp = A.SPACES[space], JA.SPACES[space]
    rng, jrng = np.random.default_rng(11), np.random.default_rng(11)
    for _ in range(200):
        c, jc = A.sample_config(rng, sp), JA.sample_config(jrng, jsp)
        assert c == jc
        enc, jenc = A.encode_config(c, sp), JA.encode_config(jc, jsp)
        assert enc.keys() == jenc.keys()
        for k in enc:
            np.testing.assert_array_equal(enc[k], np.asarray(jenc[k]))
        assert A.config_param_count(c) == JA.config_param_count(c)
        assert A.config_param_count(c, 10, 16) == JA.config_param_count(c, 10, 16)
        assert A.config_flops(c) == JA.config_flops(c)
        assert A.config_flops(c, 384) == JA.config_flops(c, 384)


@pytest.mark.parametrize("i", range(len(NARROW_CONFIGS)))
def test_narrow_supernet_matches_jax(i):
    """Logits of the sliced supernet within 1e-5 of JAX's masked one at the
    smallest, largest and four sampled configs (depths 1-3 of 3)."""
    config = NARROW_CONFIGS[i]
    m, jm = _supernet()
    x = _images()
    variables = convert_autoformer_supernet(_np_sd(m.state_dict()))
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x), _enc(config)))
    with torch.no_grad():
        got = m(torch.from_numpy(x), config=config).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_narrow_depths_cover_the_range():
    assert sorted({c["layer_num"] for c in NARROW_CONFIGS}) == [1, 2, 3]


def _upcast_einsum(einsum):
    """jnp.einsum with bf16 operands upcast where an fp32 result is asked
    for: XLA's CPU runtime has no bf16 x bf16 -> fp32 dot. bf16 values are
    exact in fp32, so the products are the same; only the order of the fp32
    sums may differ."""
    def wrapped(*args, preferred_element_type=None, **kw):
        if preferred_element_type == jnp.float32:
            args = tuple(a.astype(jnp.float32) if getattr(a, "dtype", None) == jnp.bfloat16
                         else a for a in args)
        return einsum(*args, preferred_element_type=preferred_element_type, **kw)
    return wrapped


@pytest.mark.parametrize("i", [0, 1, 2])
def test_narrow_bf16_within_four_ulps_of_jax(i, monkeypatch):
    """bf16 compute with fp32 params, the rounding points of JAX's
    attention; F.linear adds the bias inside the GEMM where flax adds it to
    the rounded product: within 4 bf16 ulps at the largest |logit|. (JAX's
    fp32-result products run on upcast operands: `_upcast_einsum`.)"""
    monkeypatch.setattr(JA.jnp, "einsum", _upcast_einsum(JA.jnp.einsum))
    config = NARROW_CONFIGS[i]
    m, jm = _supernet(torch.bfloat16)
    x = np.array(jnp.asarray(_images(8)).astype(jnp.bfloat16).astype(jnp.float32))
    variables = convert_autoformer_supernet(_np_sd(m.state_dict()))
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x), _enc(config)), np.float32)
    with torch.no_grad():
        got = m(torch.from_numpy(x), config=config).float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert np.abs(got - want).max() <= 4 * ulp, (np.abs(got - want).max(), ulp)


@pytest.mark.parametrize("i", [0, 2, 4])
def test_extract_subnet_matches_jax(i):
    """`extract_subnet` against JAX's: the same sliced weights (bit for bit
    through `autoformer_state_dict_from_jax`, the qkv rows regrouped as
    [q; k; v]), logits within 1e-5 of JAX's subnet and within 1e-6 of the
    supernet at that config."""
    config = NARROW_CONFIGS[i]
    m, _ = _supernet()
    variables = convert_autoformer_supernet(_np_sd(m.state_dict()))
    jsub, jvars = JA.extract_subnet(variables, config, JSP, num_classes=10)
    sub = A.extract_subnet(m, config)
    back = autoformer_state_dict_from_jax(jvars)
    sd = sub.state_dict()
    assert set(back) == set(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    x = _images(9)
    want = np.asarray(jax.jit(jsub.clone(patch_size=8).apply)(jvars, jnp.asarray(x)))
    with torch.no_grad():
        got = sub(torch.from_numpy(x)).numpy()
        sup = m(torch.from_numpy(x), config=config).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, sup, atol=1e-6, rtol=1e-6)


def test_state_dict_round_trip_is_exact():
    """port -> JAX (`convert_autoformer_supernet`, the reference's names) ->
    port, bit for bit."""
    m, _ = _supernet(seed=3)
    sd = m.state_dict()
    back = autoformer_state_dict_from_jax(convert_autoformer_supernet(_np_sd(sd)))
    assert set(back) == set(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)


def test_pth_from_the_port_loads_through_jax(tmp_path):
    """A `.pth` written from the port loads through JAX's
    `load_model_variables` (the reference's importer) with equal logits."""
    m, jm = _supernet(seed=4)
    torch.save({"model": m.state_dict()}, tmp_path / "af.pth")
    variables = load_model_variables(NAME, str(tmp_path / "af.pth"))
    x = _images(3)
    config = NARROW_CONFIGS[1]
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x), _enc(config)))
    with torch.no_grad():
        got = m(torch.from_numpy(x), config=config).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_one_model_object_serves_every_config():
    """No module or parameter storage is rebuilt between configs, in eval
    and across train steps; the optimizer's slots keep the super shapes."""
    m, _ = _supernet()
    modules = [id(mod) for mod in m.modules()]
    storages = {n: p.data_ptr() for n, p in m.named_parameters()}
    shapes = {n: tuple(p.shape) for n, p in m.named_parameters()}
    x = torch.from_numpy(_images())
    with torch.no_grad():
        for c in NARROW_CONFIGS[:3]:
            m(x, config=c)
    state = TrainState(m, optim.make_adamw(1e-3, params=dict(m.named_parameters())))
    step = make_supernet_train_step()
    for c in NARROW_CONFIGS[3:5]:
        step(state, {"image": x, "label": torch.tensor([1, 2])}, c)
    assert [id(mod) for mod in m.modules()] == modules
    assert {n: p.data_ptr() for n, p in m.named_parameters()} == storages
    assert {n: tuple(p.shape) for n, p in m.named_parameters()} == shapes
    assert all(tuple(s["mu"].shape) == shapes[n] for n, s in state.tx.slots.items())


def test_inactive_rows_and_columns_get_zero_grads():
    """A train step at the smallest config (depth 1, 64 of 128 embed, 1 of
    2 heads): the grads outside the active slices are exactly 0, the
    blocks past the depth get all-zero grads."""
    m, _ = _supernet()
    config = NARROW_CONFIGS[0]
    m.train()
    loss = torch.nn.functional.cross_entropy(
        m(torch.from_numpy(_images()), config=config), torch.tensor([1, 2]))
    params = dict(m.named_parameters())
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()),
                                                 materialize_grads=True)))
    emb, qd, ffn = 64, 64, int(64 * 1.5)
    assert not grads["cls_token"][..., emb:].any() and grads["cls_token"][..., :emb].any()
    assert not grads["patch_embed_super.proj.weight"][emb:].any()
    qkv = grads["blocks.0.attn.qkv.weight"]
    assert not qkv[3 * qd:].any() and not qkv[:, emb:].any() and qkv[:3 * qd, :emb].any()
    assert not grads["blocks.0.fc1.weight"][ffn:].any()
    assert not grads["blocks.0.fc2.weight"][:, ffn:].any()
    assert not grads["head.weight"][:, emb:].any()
    for k, g in grads.items():
        if k.startswith(("blocks.1.", "blocks.2.")):
            assert not g.any(), k


def test_speed_test_times_a_supernet_through_its_own_step():
    """`speed_test.supernet_step`, the timed `--train` step of a supernet
    built at a fixed config, is `make_supernet_train_step` at that config:
    the same loss and params after a step (AdamW's decay moves the
    off-path ones); `loss_and_grads`, a fixed model's step, refuses the
    blocks the config does not reach; a fixed model gets no supernet step."""
    x, y = torch.from_numpy(_images()), torch.tensor([1, 2])
    models = []
    for _ in range(2):
        m = A.AutoFormerSuper(SP, num_classes=10, img_size=32, patch_size=8,
                              drop_path_rate=0.0, config="smallest", device="cpu")
        m.load_state_dict(seeded_state_dict(m, 5))
        models.append(m)
    states = [TrainState(m, optim.make_adamw(1e-3, weight_decay=0.05, clip_grad=None))
              for m in models]
    batch = {"image": x, "label": y}
    _, got = speed_test.supernet_step(models[0])(states[0], batch, 3)
    _, want = make_supernet_train_step()(states[1], batch, NARROW_CONFIGS[0], 3)
    assert float(got["loss"]) == float(want["loss"])
    assert all(torch.equal(a, b) for a, b in zip(models[0].parameters(), models[1].parameters()))
    with pytest.raises(RuntimeError):
        loss_and_grads(models[0], batch, torch.nn.functional.cross_entropy)
    assert speed_test.supernet_step(A.extract_subnet(models[0], NARROW_CONFIGS[0])) is None


LR = dict(base_lr=1e-3, warmup_steps=1, total_steps=5, warmup_init_lr=1e-4, min_lr=1e-5)


def test_narrow_three_train_steps_match_jax():
    """3 AdamW steps (warmup + cosine, clipping 5, EMA 0.9, drop path 0) at
    three sampled configs against JAX's `make_supernet_train_step`: loss
    within 1e-5 each step, every weight and EMA weight within 1e-5 after
    (the inactive rows move by the decay and Adam's momentum alone, as in
    JAX), but for the k-projection's qkv bias: a constant per query row
    under the softmax, its grad is 0 up to float noise, which Adam's
    sign-like first update moves by up to lr either way on either side, so
    it is held to 2·Σlr."""
    m, jm = _supernet()
    params = convert_autoformer_supernet(_np_sd(m.state_dict()))["params"]
    jtx = jax_optim.make_adamw(jax_optim.cosine_schedule(*LR.values()), weight_decay=0.05,
                               clip_grad=5.0, params=params)
    jstate = JaxTrainState.create(params=params, tx=jtx, ema_decay=0.9)
    jstep = jax_supernet_step(jm)
    tx = optim.make_adamw(optim.cosine_schedule(*LR.values()), weight_decay=0.05,
                          clip_grad=5.0, params=dict(m.named_parameters()))
    state = TrainState(m, tx, ema_decay=0.9)
    step = make_supernet_train_step()
    rng = np.random.default_rng(3)
    lrs = []
    for i, config in enumerate(NARROW_CONFIGS[2:5]):
        lrs.append(state.tx.lr())
        x = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
        y = rng.integers(0, 10, 4)
        state, metrics = step(state, {"image": torch.from_numpy(x),
                                      "label": torch.from_numpy(y)}, config)
        jstate, jmetrics = jstep(jstate, {"image": jnp.asarray(x), "label": jnp.asarray(y)},
                                 _enc(config), jax.random.key(0))
        np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=1e-5)
    for got_tree, want_tree in ((state.params, jstate.params),
                                (state.ema_params, jstate.ema_params)):
        got = _leaves(convert_autoformer_supernet(_np_sd(got_tree))["params"])
        for k, w in _leaves(want_tree).items():
            err = np.abs(got[k] - w)
            if k.endswith("qkv/bias"):      # interleaved: k's units at 1, 4, 7, ...
                assert err[1::3].max() <= 2 * sum(lrs), k
                err[1::3] = 0
            assert err.max() <= 1e-5, (k, err.max())
    assert state.step == int(jstate.step) == 3


# ---- evolution ----

def _fitness(config) -> float:
    """A deterministic fitness with ties broken by the config's values."""
    return (config["embed_dim"][0] / 240 + sum(config["num_heads"]) / 100
            - sum(config["mlp_ratio"]) / 1000 - config["layer_num"] / 7)


def _searchers(batch: bool, epochs: int = 3, seed: int = 0):
    sp, jsp = A.SPACES["tiny"], JA.SPACES["tiny"]
    kw = dict(population_num=12, select_num=4, mutation_num=6, crossover_num=6,
              max_epochs=epochs, seed=seed,
              is_legal_extra=lambda c: 5.5e6 <= A.config_param_count(c) <= 9e6)
    port = evolution.EvolutionSearcher(
        sample_fn=lambda rng: A.sample_config(rng, sp), eval_fn=_fitness,
        mutate_fn=lambda rng, c: evolution.autoformer_mutate(rng, c, sp),
        crossover_fn=evolution.autoformer_crossover, **kw)
    jx = jax_evolution.EvolutionSearcher(
        sample_fn=lambda rng: JA.sample_config(rng, jsp), eval_fn=_fitness,
        batch_eval_fn=(lambda cs: [_fitness(c) for c in cs]) if batch else None,
        mutate_fn=lambda rng, c: jax_evolution.autoformer_mutate(rng, c, jsp),
        crossover_fn=jax_evolution.autoformer_crossover, **kw)
    return port, jx


@pytest.mark.parametrize("batch", [False, True])
def test_evolution_equals_jax(batch):
    """With a fixed fitness the port's searcher (candidates one by one)
    gives JAX's history and top-k, candidate for candidate, against JAX's
    serial and its chunked (`batch_eval_fn`) path."""
    port, jx = _searchers(batch)
    top, jtop = port.search(log=lambda s: None), jx.search(log=lambda s: None)
    assert port.history == jx.history and len(port.history) > 12
    assert top == jtop


def test_evolution_resume_equals_the_unbroken_run():
    """Stop after 1 epoch, carry the state through JSON, resume to 3: the
    history and top-k of the run that was not broken."""
    whole, _ = _searchers(False, epochs=3)
    whole.search(log=lambda s: None)
    first, _ = _searchers(False, epochs=1)
    first.search(log=lambda s: None)
    state = json.loads(json.dumps(first.state_dict(), default=str))
    second, _ = _searchers(False, epochs=3, seed=123)
    second.load_state_dict(state)
    second.search(log=lambda s: None)
    assert second.history == whole.history
    assert second.top_k == whole.top_k


def test_jax_resume_cannot_read_its_own_output():
    """The JAX CLI writes {"top", "state"} to --out and hands the whole
    --resume file to `load_state_dict`, which wants the state itself: a
    KeyError on its own output. The port's CLI reads either form (resumed
    from its own output in `test_clis_train_search_and_extract`)."""
    _, jx = _searchers(False, epochs=1)
    jx.search(log=lambda s: None)
    saved = json.loads(json.dumps({"top": jx.top_k, "state": jx.state_dict()}, default=str))
    _, fresh = _searchers(False, epochs=2)
    with pytest.raises(KeyError, match="epoch"):
        fresh.load_state_dict(saved)
    fresh.load_state_dict(saved["state"])
    assert fresh.epoch == 1


def test_mutation_and_crossover_equal_jax():
    sp, jsp = A.SPACES["small"], JA.SPACES["small"]
    rng, jrng = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(100):
        a, b = A.sample_config(rng, sp), JA.sample_config(jrng, jsp)
        c, d = A.sample_config(rng, sp), JA.sample_config(jrng, jsp)
        assert evolution.autoformer_mutate(rng, a, sp, 0.3) == \
            jax_evolution.autoformer_mutate(jrng, b, jsp, 0.3)
        assert evolution.autoformer_crossover(rng, a, c) == \
            jax_evolution.autoformer_crossover(jrng, b, d)


# ---- registered supernets, goldens ----

@pytest.mark.parametrize("size", ["tiny", "small", "base"])
def test_param_count_equals_jax(size):
    name = f"autoformer_supernet_{size}"
    assert name in list_models()
    m = create_model(name, device="meta")
    sp = A.SPACES[size]
    enc = {k: jnp.asarray(v) for k, v in
           A.encode_config(A.fixed_config(sp, "largest"), sp).items()}
    shapes = jax.eval_shape(lambda: jax_create_model(name).init(
        jax.random.key(0), jnp.zeros((1, 224, 224, 3)), enc))
    n_jax = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes["params"]))
    assert sum(p.numel() for p in m.parameters()) == n_jax
    assert m.config is None and create_model(name, device="meta", config="smallest").config \
        == A.fixed_config(sp, "smallest")


def golden_input(seed: int = INPUT_SEED, batch: int = 2) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((batch, 224, 224, 3)).astype(np.float32)


def golden_batch():
    rng = np.random.default_rng(INPUT_SEED + 1)
    x = rng.standard_normal((2, 224, 224, 3)).astype(np.float32)
    return x, rng.integers(0, 1000, 2)


TRAIN_CONFIG = "seed:2"


@functools.lru_cache(maxsize=None)
def _full_width_supernet():
    m = create_model(NAME, device="cpu")
    m.load_state_dict(seeded_state_dict(m, WEIGHT_SEED))
    return m


@pytest.mark.parametrize("spec", GOLDEN_CONFIGS)
def test_full_width_matches_jax_golden(spec):
    """AutoFormer-T's supernet (fp32, B=2) at the smallest, largest and a
    sampled config within 1e-4 of JAX's stored logits, and its extracted
    subnet within 1e-5 of the largest |logit| of the supernet's."""
    g = np.load(GOLDEN)
    assert int(g["input_seed"]) == INPUT_SEED and int(g["weight_seed"]) == WEIGHT_SEED
    m = _full_width_supernet()
    config = A.fixed_config(m.space, spec)
    assert json.loads(str(g[f"config_{spec}"])) == config
    x = torch.from_numpy(golden_input())
    with torch.no_grad():
        got = m(x, config=config)
        sub = A.extract_subnet(m, config)(x)
    np.testing.assert_allclose(got.numpy(), g[f"logits_{spec}"], atol=1e-4, rtol=1e-4)
    assert (sub - got).abs().max() <= 1e-5 * got.abs().max()


def test_full_width_train_step_matches_jax_golden():
    """One fp32 B=2 supernet step (drop path 0) at a sampled config: loss
    1e-5, global grad norm 1e-4, per-tensor grad norms 1e-3 (the tensors
    of blocks past the depth 0 on both sides)."""
    g = np.load(TRAIN_GOLDEN)
    m = create_model(NAME, device="cpu", drop_path_rate=0.0)
    m.load_state_dict(seeded_state_dict(m, WEIGHT_SEED))
    config = A.fixed_config(m.space, TRAIN_CONFIG)
    assert json.loads(str(g["config"])) == config
    x, y = golden_batch()
    m.train()
    loss = torch.nn.functional.cross_entropy(m(torch.from_numpy(x), config=config),
                                             torch.from_numpy(y))
    params = dict(m.named_parameters())
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()),
                                                 materialize_grads=True)))
    assert sorted(grads) == list(g["names"])
    np.testing.assert_allclose(float(loss.detach()), float(g["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(optim.global_norm(grads.values())), float(g["grad_norm"]),
                               rtol=1e-4)
    got = np.asarray([float(grads[n].norm()) for n in g["names"]])
    np.testing.assert_allclose(got, g["grad_norms"], rtol=1e-3,
                               atol=1e-7 * float(g["grad_norm"]))


# ---- the CLIs ----

def _cli_opts(tmp_path, batch=4):
    return ["model.dtype=float32", "model.num_classes=10", "model.img_size=32",
            "data.img_size=32", "data.dataset=synthetic", f"data.batch_size={batch}",
            "data.num_workers=2", f"output={tmp_path}"]


def test_clis_train_search_and_extract(tmp_path, capsys):
    """supernet_train (2 epochs; a third resumed from the newest
    checkpoint), then search_evolution from its checkpoint, a resume from
    the CLI's own output (the finished search, unchanged), the refusals,
    and the best config's extracted subnet against the supernet."""
    train_opts = ["--device", "cpu", "--space", "tiny", "train.warmup_epochs=0"] \
        + _cli_opts(tmp_path, batch=16)
    ckpt = supernet_train.main(train_opts + ["train.epochs=2"])
    assert "epoch 1: mean loss" in capsys.readouterr().out
    supernet_train.main(train_opts + ["train.epochs=3"])
    out = capsys.readouterr().out
    assert "auto-resumed from step 8 (epoch 2)" in out and "epoch 2: mean loss" in out
    search = ["--device", "cpu", "--space", "tiny", "--param-min", "5e6", "--param-max",
              "9e6", "--population", "4", "--max-eval-batches", "1"]
    opts = _cli_opts(tmp_path, batch=8)
    top = search_evolution.main(search + [
        "--ckpt", ckpt, "--epochs", "1", "--out", str(tmp_path / "evo.json")] + opts)
    run = json.load(open(tmp_path / "evo.json"))
    assert len(run["state"]["history"]) > 4 and top[0][0] == run["top"][0][0]
    resumed = search_evolution.main(search + [
        "--ckpt", ckpt, "--epochs", "1", "--resume", str(tmp_path / "evo.json"),
        "--out", str(tmp_path / "evo_r.json")] + opts)
    # the finished search resumed from the CLI's own output: nothing more to score
    state, done = json.load(open(tmp_path / "evo_r.json"))["state"], run["state"]
    assert set(state.pop("visited")) == set(done.pop("visited")) and state == done
    for bad in ([], ["--ckpt", ckpt, "--evo-subset", "10"]):
        with pytest.raises(SystemExit):
            search_evolution.main(search + bad + ["--out", str(tmp_path / "x.json")]
                                  + opts)
    best = resumed[0][1]
    m = create_model(NAME, device="cpu", num_classes=10, img_size=32)
    from cream_tpu_torch.core.checkpoint import restore_params
    m.load_state_dict(restore_params(ckpt))
    m.eval()
    x = torch.from_numpy(_images(2, batch=4))
    with torch.no_grad():
        np.testing.assert_allclose(A.extract_subnet(m, best)(x).numpy(),
                                   m(x, config=best).numpy(), atol=1e-5)


# ---- the golden files ----

def _name_bridge(model) -> dict[str, str]:
    """JAX param path -> port param name (a unique value per param carried
    through the converter)."""
    names = list(dict(model.named_parameters()))
    ids = {k: torch.full_like(p, float(i)) for i, (k, p) in enumerate(model.named_parameters())}
    bridge = {path: names[int(v.flat[0])]
              for path, v in _leaves(convert_autoformer_supernet(_np_sd(ids))["params"]).items()}
    assert sorted(bridge.values()) == sorted(names)
    return bridge


def write_goldens() -> None:
    port = create_model(NAME, device="cpu")
    variables = convert_autoformer_supernet(_np_sd(seeded_state_dict(port, WEIGHT_SEED)))
    sp = A.SPACES["tiny"]
    out = {"input_seed": np.int64(INPUT_SEED), "weight_seed": np.int64(WEIGHT_SEED)}
    apply = jax.jit(jax_create_model(NAME).apply)
    for spec in GOLDEN_CONFIGS:
        config = A.fixed_config(sp, spec)
        out[f"logits_{spec}"] = np.asarray(apply(variables, jnp.asarray(golden_input()),
                                                 _enc(config, sp)), np.float32)
        out[f"config_{spec}"] = np.asarray(json.dumps(config))
    np.savez(GOLDEN, **out)
    print(f"wrote {GOLDEN}")
    config = A.fixed_config(sp, TRAIN_CONFIG)
    jm = jax_create_model(NAME, drop_path_rate=0.0)
    x, y = golden_batch()

    def f(p):
        logits = jm.apply({"params": p}, x, _enc(config, sp), train=True)
        return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()
    loss, grads = jax.jit(jax.value_and_grad(f))(variables["params"])
    bridge = _name_bridge(port)
    flat = {bridge[p]: g for p, g in _leaves(grads).items()}
    names = sorted(flat)
    np.savez_compressed(TRAIN_GOLDEN, loss=np.float32(loss),
                        grad_norm=np.float32(optax.global_norm(grads)),
                        names=np.asarray(names), config=np.asarray(json.dumps(config)),
                        grad_norms=np.asarray([np.linalg.norm(flat[n]) for n in names],
                                              np.float32),
                        input_seed=np.int64(INPUT_SEED), weight_seed=np.int64(WEIGHT_SEED))
    print(f"wrote {TRAIN_GOLDEN}")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    DATA.mkdir(parents=True, exist_ok=True)
    write_goldens()
