"""cream_tpu_torch's NAS-Bench-201 space (`models/nasbench201.py`: the search
and infer networks, the arch-string codec, the bridge) and the cyclic
searcher (`nas/cdarts.py`) on it, against the JAX package's, on shared
seeded weights and numpy-seeded inputs (fp32 unless a test says otherwise).

Weights: `seeded_state_dict` on the port's model, carried to JAX through
`zoo.load.nasbench201_state_dict_from_jax` inverted
(`torch_port_bridges.jax_variables_from_port`). Regenerate the full-width
golden (nasbench201_infer on `EXAMPLE_ARCH`, fp32 B=2 logits) with
    PYTHONPATH=.:tests python tests/test_torch_nasbench201.py
"""
import functools
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from cream_tpu.models import create_model as jax_create_model
from cream_tpu.models import nasbench201 as JN
from cream_tpu.nas import cdarts as jax_cdarts
from cream_tpu_torch.models import create_model
from cream_tpu_torch.models import nasbench201 as N
from cream_tpu_torch.nas import cdarts
from cream_tpu_torch.zoo.load import nasbench201_state_dict_from_jax, seeded_state_dict
from torch_port_bridges import assert_bridge_inverts, jax_variables_from_port
from torch_threads import one_torch_thread_module  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "data" / "torch_port" / "nasbench201_infer_seed0.npz"
WEIGHT_SEED, INPUT_SEED = 0, 1
NARROW = dict(num_classes=5, C=4, N=1)


def _np(t):
    return t.detach().cpu().numpy().copy()


def images(seed=2, batch=2, size=16):
    return np.random.default_rng(seed).standard_normal((batch, size, size, 3)).astype(np.float32)


def seeded(m, seed=WEIGHT_SEED):
    m.load_state_dict(seeded_state_dict(m, seed))
    return m


def np_alphas(seed, scale=1.0):
    a = (scale * np.random.default_rng(seed).standard_normal((N.N_EDGES, 5))).astype(np.float32)
    return {"normal": a, "reduce": np.zeros_like(a)}


# ---- the codec ----

@pytest.mark.parametrize("seed", range(4))
def test_codec_matches_jax(seed):
    """parse_structure, structure_tostr / fromstr and check_valid give JAX's
    on random alphas and random archs."""
    a = np_alphas(seed)
    g = N.parse_structure(a)
    assert g == JN.parse_structure(a)
    s = N.structure_tostr(g)
    assert s == JN.structure_tostr(g) and N.structure_fromstr(s) == JN.structure_fromstr(s) == g
    rng = np.random.default_rng(seed)
    for _ in range(50):
        arch = tuple(tuple((N.NB201_OPS[rng.integers(5)], j) for j in range(i))
                     for i in range(1, 4))
        assert N.structure_check_valid(arch) == JN.structure_check_valid(arch)
        assert N.structure_fromstr(N.structure_tostr(arch)) == arch
    assert N.parse_structure(torch.from_numpy(a["normal"])) == g


# ---- the networks ----

@functools.lru_cache(maxsize=None)
def _jax_search():
    jm = JN.TinyNetwork201(**NARROW)
    a = jnp.zeros((N.N_EDGES, 5))
    template = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((2, 16, 16, 3)), a))

    def loss(v, x, an, y):
        lg = jm.apply(v, x, an)
        return optax.softmax_cross_entropy_with_integer_labels(lg, y).mean(), lg
    return jm, template, jax.jit(jax.value_and_grad(loss, argnums=2, has_aux=True))


def test_search_network_matches_jax():
    """The narrow TinyNetwork201 (C 4, N 1): eval loss, logits and alpha
    grads within 1e-5 of JAX's; train-mode logits within 1e-5; the bridge
    inverts bit for bit."""
    m = seeded(N.TinyNetwork201(**NARROW)).eval()
    jm, template, grad = _jax_search()
    variables = jax_variables_from_port(m.state_dict(), template,
                                        nasbench201_state_dict_from_jax)
    assert_bridge_inverts(m.state_dict(), variables, nasbench201_state_dict_from_jax)
    x, a, y = images(), np_alphas(3), np.array([0, 4])
    (loss, logits), g = grad(variables, jnp.asarray(x), a["normal"], jnp.asarray(y))
    ta = torch.tensor(a["normal"], requires_grad=True)
    out = m(torch.from_numpy(x), ta)
    tl = torch.nn.functional.cross_entropy(out, torch.from_numpy(y))
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(loss), atol=1e-5)
    np.testing.assert_allclose(_np(out), np.asarray(logits), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(ta.grad), np.asarray(g), atol=1e-5)
    want, _ = jax.jit(lambda v, x: jm.apply(v, x, a["normal"], train=True,
                                            mutable=["batch_stats"]))(variables, jnp.asarray(x))
    with torch.no_grad():
        got = m.train()(torch.from_numpy(x), torch.from_numpy(a["normal"]))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch", [N.EXAMPLE_ARCH, "parsed", "|none~0|+|none~0|none~1|+|skip_connect~0|none~1|none~2|"])
def test_infer_network_matches_jax(arch):
    """TinyNetwork201Infer (C 4, N 1) on the example arch (every op), a
    parsed one and an arch without a conv (its cells have no variables):
    eval and train logits within 1e-5 of JAX's."""
    if arch == "parsed":
        arch = N.structure_tostr(N.parse_structure(np_alphas(7)))
    m = seeded(create_model("nasbench201_infer", genotype=arch, device="cpu", **NARROW))
    jm = jax_create_model("nasbench201_infer", genotype=arch, **NARROW)
    x = images(5)
    template = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.asarray(x)))
    kw = dict(genotype=arch, N=1)
    variables = jax_variables_from_port(m.state_dict(), template,
                                        nasbench201_state_dict_from_jax, **kw)
    assert_bridge_inverts(m.state_dict(), variables, nasbench201_state_dict_from_jax, **kw)
    for train in (False, True):
        want = jax.jit(lambda v, x: jm.apply(v, x, train=train, mutable=[
            "batch_stats"] if train else False))(variables, jnp.asarray(x))
        with torch.no_grad():
            got = m.train(train)(torch.from_numpy(x))
        np.testing.assert_allclose(_np(got), np.asarray(want[0] if train else want),
                                   atol=1e-5, rtol=1e-5)


def test_avg_pool_counts_the_padding():
    """201's avg_pool_3x3 counts the padding (DARTS' does not): a corner of
    a map of ones averages to 4/9."""
    op = N.make_op("avg_pool_3x3", 2)
    y = N._apply(op, torch.ones(1, 4, 4, 2))
    assert torch.allclose(y[0, 0, 0], torch.full((2,), 4 / 9))


@pytest.mark.parametrize("name", ["nasbench201_search", "nasbench201_infer"])
def test_registered_param_counts_equal_jax(name):
    """Both registered names (C 16, N 5) build the JAX package's parameter
    count (params and BN statistics)."""
    kw = {"genotype": N.EXAMPLE_ARCH} if name.endswith("infer") else {}
    args = (jnp.zeros((1, 32, 32, 3)),) + (() if kw else (jnp.zeros((6, 5)),))
    m = create_model(name, device="cpu", **kw)
    shapes = jax.eval_shape(lambda: jax_create_model(name, **kw).init(jax.random.key(0), *args))
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    assert n_jax == sum(v.numel() for k, v in m.state_dict().items()
                        if not k.endswith("num_batches_tracked"))


# ---- the cyclic searcher ----

def test_cyclic_searcher_matches_jax():
    """Both packages' CyclicSearcher on the narrow 201 network from the same
    weights and alphas (SGD 0.05 / 0.9, Adam 3e-4 b1 0.5): 3 weight and 3
    alpha steps, the last two against eval-net logits; losses within 1e-4 a
    step, the alphas within 1e-5 after each alpha step, the BN statistics
    within 1e-5 at the end (fp32)."""
    m = seeded(N.TinyNetwork201(**NARROW))
    jm, template, _ = _jax_search()
    variables = jax_variables_from_port(m.state_dict(), template,
                                        nasbench201_state_dict_from_jax)
    a0 = np_alphas(12, 1e-3)
    js = jax_cdarts.CyclicSearcher(jm, {k: jnp.asarray(v) for k, v in a0.items()},
                                   variables["params"], variables["batch_stats"])
    ps = cdarts.CyclicSearcher(m, {k: torch.from_numpy(v.copy()) for k, v in a0.items()})
    rng = np.random.default_rng(11)
    el = rng.standard_normal((4, 5)).astype(np.float32)
    for i in range(3):
        b = {"image": images(20 + i, 4), "label": rng.integers(0, 5, 4)}
        e = None if i == 0 else el
        pw = ps.weight_step({k: torch.from_numpy(v) for k, v in b.items()})
        pa = ps.alpha_step({k: torch.from_numpy(v) for k, v in b.items()},
                           None if e is None else torch.from_numpy(e))
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        jw, ja = js.weight_step(jb), js.alpha_step(jb, e)
        assert abs(pw - jw) <= 1e-4 and abs(pa - ja) <= 1e-4, (i, pw, jw, pa, ja)
        for k in a0:
            np.testing.assert_allclose(_np(ps.alphas[k]), np.asarray(js.alphas[k]), atol=1e-5)
    back = nasbench201_state_dict_from_jax({"params": js.params,
                                            "batch_stats": js.batch_stats})
    for k, v in m.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(_np(v), back[k].numpy(), atol=1e-5, err_msg=k)
    assert ps.genotype() == JN.parse_structure(js.alphas)


def test_jax_searcher_genotype_refuses_201():
    """A JAX-side fault recorded (ROADMAP Queue 3): the JAX package's
    CyclicSearcher.genotype() calls DARTS' parse_genotype, which refuses the
    201 space's 6 edges; the port's searcher decodes a 201 network with
    parse_structure."""
    a = np_alphas(1)
    with pytest.raises(AssertionError):
        jax_cdarts.CyclicSearcher.genotype(type("S", (), {"alphas": a})())
    ps = cdarts.CyclicSearcher(N.TinyNetwork201(**NARROW),
                               {k: torch.from_numpy(v) for k, v in a.items()})
    assert ps.genotype() == JN.parse_structure(a)


def test_l1_regularization_takes_darts_columns():
    """`alpha_l1_regularization` sums the softmax weight of DARTS' three
    parameter-free columns (0, 1, 2) of every alpha set, 201's too (there
    'none', 'skip_connect' and 'nor_conv_1x1'), as the JAX package does
    (ROADMAP Queue 3): equal to JAX's within 1e-6."""
    a = np_alphas(4)
    got = float(cdarts.alpha_l1_regularization({k: torch.from_numpy(v) for k, v in a.items()}))
    want = float(jax_cdarts.alpha_l1_regularization({k: jnp.asarray(v) for k, v in a.items()}))
    assert abs(got - want) <= 1e-6


# ---- the full-width golden ----

def golden_inputs():
    return images(INPUT_SEED, 2, 32)


def test_full_width_infer_golden():
    """nasbench201_infer (C 16, N 5) on EXAMPLE_ARCH and seeded weights:
    fp32 B=2 logits within 1e-3 of the JAX package's stored logits."""
    g = np.load(GOLDEN)
    m = seeded(create_model("nasbench201_infer", genotype=N.EXAMPLE_ARCH, device="cpu"),
               int(g["weight_seed"]))
    with torch.no_grad():
        got = m(torch.from_numpy(golden_inputs())).numpy()
    assert np.abs(got - g["logits"]).max() <= 1e-3


def write_golden():
    m = seeded(create_model("nasbench201_infer", genotype=N.EXAMPLE_ARCH, device="cpu"))
    jm = jax_create_model("nasbench201_infer", genotype=N.EXAMPLE_ARCH)
    x = jnp.asarray(golden_inputs())
    template = jax.eval_shape(lambda: jm.init(jax.random.key(0), x))
    variables = jax_variables_from_port(m.state_dict(), template,
                                        nasbench201_state_dict_from_jax,
                                        genotype=N.EXAMPLE_ARCH)
    np.savez(GOLDEN, logits=np.asarray(jax.jit(jm.apply)(variables, x)),
             weight_seed=WEIGHT_SEED, input_seed=INPUT_SEED)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    write_golden()
