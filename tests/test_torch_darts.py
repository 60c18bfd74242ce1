"""cream_tpu_torch's DARTS layer (`models/darts.py`: the primitives, the
search cell and network, the discrete cells, the CDARTS retrain network, the
genotype codecs; the `zoo.load` bridges and `load_cdarts_retrain`; the
cyclic searcher on the DARTS network) against the JAX package's, on shared
seeded weights and numpy-seeded inputs.

Weights: `seeded_state_dict` on the port's model (BN statistics away from
0/1), carried to JAX through the port's bridge
(`torch_port_bridges.jax_variables_from_port`; the retrain network through
the JAX package's own `convert_cdarts_retrain`). Live comparisons run at
narrow sizes (C 4-8, 2-3 layers, 2-4 nodes, 16-64 px): JAX compiles a
search network slowly. Full width is held to goldens the JAX package wrote
(fp32, seed 0); regenerate them with
    PYTHONPATH=.:tests python tests/test_torch_darts.py
"""
import functools
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp
import optax

from cream_tpu.models import create_model as jax_create_model
from cream_tpu.models import darts as JD
from cream_tpu.zoo.import_torch import convert_cdarts_retrain
from cream_tpu.zoo.load import load_cdarts_retrain as jax_load_cdarts_retrain
from cream_tpu_torch.models import create_model
from cream_tpu_torch.models import darts as D
from cream_tpu_torch.nn import layers
from cream_tpu_torch.nn.layers import set_dw_kernel
from cream_tpu_torch.zoo import load
from cream_tpu_torch.zoo.load import seeded_state_dict
from torch_port_bridges import assert_bridge_inverts, jax_variables_from_port
from torch_threads import one_torch_thread_module  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
DATA = REPO / "tests" / "data" / "torch_port"
RETRAIN_GOLDEN = DATA / "cdarts_retrain_imagenet_seed0.npz"
SEARCH_GOLDEN = DATA / "darts_search_cifar_seed0.npz"
WEIGHT_SEED, INPUT_SEED = 0, 1


def _np(t):
    return t.detach().cpu().numpy().copy()


def images(seed=2, batch=2, size=16, C=3):
    return np.random.default_rng(seed).standard_normal((batch, size, size, C)).astype(np.float32)


def np_alphas(seed, e, scale=1.0, n_ops=len(D.PRIMITIVES)):
    """Alphas far enough from uniform that the ops' weights differ."""
    rng = np.random.default_rng(seed)
    return {k: (scale * rng.standard_normal((e, n_ops))).astype(np.float32)
            for k in ("normal", "reduce")}


def seeded(m, seed=WEIGHT_SEED):
    m.load_state_dict(seeded_state_dict(m, seed))
    return m


# ---- the primitives ----

class JaxOp(fnn.Module):
    prim: str
    C: int
    stride: int

    @fnn.compact
    def __call__(self, x, train=False):
        return JD.make_op(self.prim, self.C, self.stride, module_name="op")(x, train)


def op_bridge(variables):
    w = load._Writer(variables)
    if "op" in w.params:
        load._darts_op(w, "op", "0")
    return w.state_dict()


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("prim", D.PRIMITIVES)
def test_primitive_matches_jax(prim, stride):
    """Each primitive at both strides, eval and train mode (the output and
    the BN statistics it leaves), within 1e-5 of JAX's (fp32)."""
    C = 8
    x = images(3, 2, 16, C)
    port = seeded(torch.nn.Sequential(D.make_op(prim, C, stride)), 4)
    jm = JaxOp(prim, C, stride)
    template = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.asarray(x)))
    variables = (jax_variables_from_port(port.state_dict(), template, op_bridge)
                 if jax.tree_util.tree_leaves(template) else {})
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x))
    want = jm.apply(variables, jnp.asarray(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5, rtol=1e-5)
    if "batch_stats" not in variables:
        return
    with torch.no_grad():
        got = port.train()(torch.from_numpy(x))
    want, mut = jm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5, rtol=1e-5)
    back = op_bridge({"params": variables["params"], "batch_stats": mut["batch_stats"]})
    for k, v in back.items():
        if "running" in k:
            np.testing.assert_allclose(_np(port.state_dict()[k]), v.numpy(), atol=1e-6)


def test_pool_bn_matches_jax():
    """PoolBN (kept though no op builds it): max and avg, train mode, within
    1e-5 (flax's fast variance, E[x²] - E[x]², rounds a few 1e-6 off)."""
    x = images(5, 2, 16, 8)
    for mode in ("max", "avg"):
        port = D.PoolBN(mode, 8, 2).train()
        with torch.no_grad():
            got = port(torch.from_numpy(x))
        jm = JD.PoolBN(mode, 2)
        v = jm.init(jax.random.key(0), jnp.asarray(x))
        want, mut = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(_np(port.bn.running_var),
                                   np.asarray(mut["batch_stats"]["bn"]["var"]), atol=1e-6)


# ---- the search cell and network ----

class JaxCell(fnn.Module):
    n_nodes: int
    C: int
    red_p: bool
    red: bool

    @fnn.compact
    def __call__(self, s0, s1, w_dag, w_edge, train=False):
        return JD.SearchCell(self.n_nodes, self.C, self.red_p, self.red, name="cell")(
            s0, s1, w_dag, w_edge, train)


def cell_bridge(variables, search=True):
    w = load._Writer(variables)
    load._darts_cell(w, "cell", "cell", search=search)
    return w.state_dict()


@pytest.mark.parametrize("red_p,red", [(False, False), (True, True)])
def test_search_cell_matches_jax(red_p, red):
    """A SearchCell with edge weights (the controller's form): the output
    and the grads of the op and edge weights within 1e-5 of JAX's, train
    mode (fp32)."""
    n, C = 2, 4
    e = D.n_alpha_edges(n)
    s0 = images(6, 2, 16 if red_p else 8, 6)
    s1 = images(7, 2, 8, 5)
    port = torch.nn.ModuleDict({"cell": D.SearchCell(n, 6, 5, C, red_p, red)})
    seeded(port, 8).train()
    rng = np.random.default_rng(9)
    w_dag = jax.nn.softmax(jnp.asarray(rng.standard_normal((e, 8)), jnp.float32), -1)
    w_edge = jnp.asarray(rng.uniform(0.2, 1.0, e), jnp.float32)
    jm = JaxCell(n, C, red_p, red)
    args = tuple(jnp.asarray(a) for a in (s0, s1))
    template = jax.eval_shape(lambda: jm.init(jax.random.key(0), *args, w_dag, w_edge))
    variables = jax_variables_from_port(port.state_dict(), template, cell_bridge)

    def jax_out(wd, we):
        return jm.apply(variables, *args, wd, we, train=True, mutable=["batch_stats"])[0]
    want, (gd, ge) = jax.jit(jax.value_and_grad(lambda wd, we: jax_out(wd, we).sum(),
                                                argnums=(0, 1)))(w_dag, w_edge)
    want = jax_out(w_dag, w_edge)
    twd = torch.tensor(np.asarray(w_dag), requires_grad=True)
    twe = torch.tensor(np.asarray(w_edge), requires_grad=True)
    got = port["cell"](torch.from_numpy(s0), torch.from_numpy(s1), twd, twe)
    got.sum().backward()
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(twd.grad), np.asarray(gd), atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(_np(twe.grad), np.asarray(ge), atol=1e-4, rtol=1e-5)


def test_jax_search_preproc_is_affine():
    """A JAX-side difference kept (ROADMAP Queue 3): the reference builds a
    search cell's preprocessing and ops with `affine=False`, while the JAX
    package's SearchCell (`StdConv.affine` is never passed on) gives its
    preproc BNs, and the MixedOp conv ops' BNs, a scale and a bias. The
    port follows the JAX package (its BNs are affine too)."""
    jm = JaxCell(2, 4, False, False)
    x = jnp.zeros((1, 8, 8, 4))
    w = jnp.ones((5, 8)) / 8
    v = jax.eval_shape(lambda: jm.init(jax.random.key(0), x, x, w, jnp.ones(5)))
    cell = v["params"]["cell"]
    assert set(cell["preproc0"]["conv_bn"]["bn"]) == {"scale", "bias"}
    assert {"scale", "bias"} <= set(cell["dag_0_0"]["op_3"]["bn0"])
    port = D.SearchCell(2, 4, 4, 4, False, False)
    assert port.preproc0.net[2].affine and port.dag[0][0]._ops[3].net[0].net[3].affine


SEARCH_NARROW = dict(num_classes=5, C=4, n_layers=3, n_nodes=2)


@functools.lru_cache(maxsize=None)
def _jax_search(dtype=jnp.float32):
    jm = JD.SearchCNN(dtype=dtype, **SEARCH_NARROW)
    x = jnp.zeros((2, 16, 16, 3))
    a = jnp.zeros((D.n_alpha_edges(2), 8))
    template = jax.eval_shape(lambda: jm.init(jax.random.key(0), x, a, a))

    def loss(v, x, an, ar, y):
        logits = jm.apply(v, x, an, ar)
        ce = optax.softmax_cross_entropy_with_integer_labels(logits.astype(jnp.float32), y)
        return ce.mean(), logits
    grad = jax.jit(jax.value_and_grad(loss, argnums=(2, 3), has_aux=True))
    return jm, template, grad


def _port_search(dtype=torch.float32):
    m = D.SearchCNN(dtype=dtype, **SEARCH_NARROW)
    return seeded(m)


def test_search_cnn_matches_jax():
    """The narrow SearchCNN (C 4, 3 layers with two reductions, 2 nodes):
    in eval mode (the alpha step's) the CE loss and logits within 1e-5 and
    the alpha grads within 1e-5 of JAX's; in train mode the logits and the
    BN statistics left within 1e-5 (fp32); the bridge inverts bit for bit."""
    m = _port_search().eval()
    jm, template, grad = _jax_search()
    variables = jax_variables_from_port(m.state_dict(), template,
                                        load.darts_search_state_dict_from_jax)
    assert_bridge_inverts(m.state_dict(), variables, load.darts_search_state_dict_from_jax)
    x, a = images(), np_alphas(3, D.n_alpha_edges(2))
    y = np.array([1, 3])
    (loss, logits), (gn, gr) = grad(variables, jnp.asarray(x), a["normal"], a["reduce"],
                                    jnp.asarray(y))
    ta = {k: torch.tensor(v, requires_grad=True) for k, v in a.items()}
    out = m(torch.from_numpy(x), ta["normal"], ta["reduce"])
    tl = torch.nn.functional.cross_entropy(out, torch.from_numpy(y))
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(loss), atol=1e-5)
    np.testing.assert_allclose(_np(out), np.asarray(logits), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(ta["normal"].grad), np.asarray(gn), atol=1e-5)
    np.testing.assert_allclose(_np(ta["reduce"].grad), np.asarray(gr), atol=1e-5)
    want, mut = jax.jit(lambda v, x: jm.apply(v, x, a["normal"], a["reduce"], train=True,
                                              mutable=["batch_stats"]))(variables, jnp.asarray(x))
    with torch.no_grad():
        got = m.train()(torch.from_numpy(x), *(torch.from_numpy(a[k]) for k in ("normal",
                                                                                "reduce")))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5, rtol=1e-5)
    back = load.darts_search_state_dict_from_jax({"params": variables["params"],
                                                  "batch_stats": mut["batch_stats"]})
    for k, v in m.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(_np(v), back[k].numpy(), atol=1e-5, err_msg=k)


def test_search_cnn_bf16_matches_jax():
    """bf16 compute with JAX's rounding points (fp32 op weighting, fp32
    search-cell states, convs on bf16 casts): logits within 4 bf16 ulps of
    the largest |logit| of JAX's bf16 logits, eval mode."""
    m = _port_search(torch.bfloat16).eval()
    jm, template, _ = _jax_search(jnp.bfloat16)
    variables = jax_variables_from_port(m.state_dict(), template,
                                        load.darts_search_state_dict_from_jax)
    x, a = images(), np_alphas(3, D.n_alpha_edges(2))
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x), a["normal"], a["reduce"]),
                      np.float32)
    with torch.no_grad():
        got = m(torch.from_numpy(x), torch.from_numpy(a["normal"]),
                torch.from_numpy(a["reduce"])).float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert np.abs(got - want).max() <= 4 * ulp, (np.abs(got - want).max(), ulp)


def test_search_network_refuses_nothing_and_counts_its_sites(monkeypatch):
    """`dw3x3_path_sites` equals the kernel routes a `"fused"` forward
    takes, by stride, on the search network and the retrain network; on
    the CPU the routes run the plain versions, within 1e-5 of the library
    route's logits."""
    taken, real = [], layers.dw_route

    def spy(mode, conv, stride, padding, groups, x):
        fn = real(mode, conv, stride, padding, groups, x)
        if fn is not None:
            taken.append(stride)
        return fn
    monkeypatch.setattr(layers, "dw_route", spy)
    layers.DW_REFUSED.clear()
    x, a = images(), np_alphas(3, D.n_alpha_edges(2))
    m = _port_search().eval()
    for net, args in ((m, (torch.from_numpy(a["normal"]), torch.from_numpy(a["reduce"]))),
                      (seeded(D.CDARTSRetrain([D.EXAMPLE_GENOTYPE] * 3, init_channels=4,
                                              num_classes=5)).eval(), ())):
        xin = torch.from_numpy(images(4, 2, 64 if args == () else 16))
        with torch.no_grad():
            want = net(xin, *args)
            set_dw_kernel(net, "fused")
            taken.clear()
            got = net(xin, *args)
            set_dw_kernel(net, "library")
        assert (taken.count(1), taken.count(2)) == D.dw3x3_path_sites(net)
        assert taken.count(2) > 0
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)
    assert not layers.DW_REFUSED
    full = create_model("darts_search_cifar", device="cpu")
    assert D.dw3x3_path_sites(full) == (208, 16)      # 224 sites a forward


def test_step_launch_rule_is_the_routes_a_step_runs(monkeypatch):
    """`dw3x3_step_launches` (the launches the card checks expect of a
    search step on "fused") equals the kernel routes the narrow search
    network's weight step and alpha step take, forward (`dw_route`) and
    backward (`dwconv.dw_conv3x3_bwd`, which autograd runs only where the
    step's grads reach), by stride."""
    from cream_tpu_torch.nas.cdarts import make_alpha_adam, make_alpha_step, make_weight_step
    from cream_tpu_torch.ops import dwconv
    from cream_tpu_torch.train.optim import make_sgd
    fwd, bwd, real_route, real_bwd = [], [], layers.dw_route, dwconv.dw_conv3x3_bwd

    def route(mode, conv, stride, padding, groups, x):
        fn = real_route(mode, conv, stride, padding, groups, x)
        if fn is not None:
            fwd.append(stride)
        return fn

    def backward(x, dy, w9, stride=1):
        bwd.append(stride)
        return real_bwd(x, dy, w9, stride)
    monkeypatch.setattr(layers, "dw_route", route)
    monkeypatch.setattr(dwconv, "dw_conv3x3_bwd", backward)
    m = D.SearchCNN(num_classes=5, C=4, n_layers=4, n_nodes=3)
    seeded(m)
    set_dw_kernel(m, "fused")
    a = {k: torch.from_numpy(v) for k, v in np_alphas(3, D.n_alpha_edges(3), 1e-3).items()}
    b = {"image": torch.from_numpy(images(8, 2)), "label": torch.tensor([1, 2])}
    for step, alpha in ((make_weight_step(m, make_sgd(0.05)), False),
                        (make_alpha_step(m, make_alpha_adam()), True)):
        fwd.clear()
        bwd.clear()
        step(a, b, *(() if not alpha else (torch.zeros(2, 5),)))
        want = D.dw3x3_step_launches(m, alpha)
        assert (fwd.count(1), fwd.count(2)) == (want["k7_fwd"], want["k9_fwd"])
        assert (bwd.count(1), bwd.count(2)) == (want["k7_bwd"], want["k9_bwd"])
    assert want["k7_bwd"] < want["k7_fwd"]


# ---- genotypes ----

@pytest.mark.parametrize("seed", range(6))
def test_parse_genotype_matches_jax(seed):
    """parse_genotype on the same alphas (DARTS' init scale 1e-3 and a wide
    one) gives JAX's genotype; the repr string round-trips through both
    packages' genotype_from_str. No test alphas put a node's top two edges
    within 1e-6 of each other."""
    for n in (2, 4):
        for scale in (1e-3, 1.0):
            a = np_alphas(seed, D.n_alpha_edges(n), scale)
            got, want = D.parse_genotype(a), JD.parse_genotype(a)
            assert got == want
            assert D.genotype_from_str(repr(got)) == JD.genotype_from_str(repr(want)) == got


def test_genotype_from_str_namespace():
    """Only Genotype and range are in the eval namespace; the cell_file form
    (concat as range(2, 6)) parses."""
    s = ("Genotype(normal=[[('sep_conv_3x3', 0), ('skip_connect', 1)]], "
         "normal_concat=range(2, 3), reduce=[[('max_pool_3x3', 0), ('dil_conv_5x5', 1)]], "
         "reduce_concat=range(2, 3))")
    assert D.genotype_from_str(s) == JD.genotype_from_str(s)
    with pytest.raises(NameError):
        D.genotype_from_str("__import__('os')")
    assert D.as_genotypes({"1": s, "0": repr(D.EXAMPLE_GENOTYPE)})[0] == D.EXAMPLE_GENOTYPE


# ---- the discrete networks ----

def test_augment_cnn_matches_jax():
    """AugmentCNN (C 4, 3 layers) on the example genotype (every primitive
    but 'none', stride-2 edges in the reduce cell): eval and train logits
    within 1e-5 of JAX's; the bridge inverts bit for bit."""
    m = seeded(D.AugmentCNN(D.EXAMPLE_GENOTYPE, num_classes=5, C=4, n_layers=3))
    jm = JD.AugmentCNN(genotype=D.EXAMPLE_GENOTYPE, num_classes=5, C=4, n_layers=3)
    x = images(5, 2, 16)
    template = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.asarray(x)))
    variables = jax_variables_from_port(m.state_dict(), template,
                                        load.darts_augment_state_dict_from_jax)
    assert_bridge_inverts(m.state_dict(), variables, load.darts_augment_state_dict_from_jax)
    for train in (False, True):
        with torch.no_grad():
            got = m.train(train)(torch.from_numpy(x))
        want = jax.jit(lambda v, x: jm.apply(v, x, train=train, mutable=[
            "batch_stats"] if train else False))(variables, jnp.asarray(x))
        want = want[0] if train else want
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5, rtol=1e-5)


RETRAIN_CASES = [("imagenet", False, 64), ("imagenet", True, 64), ("cifar", False, 32)]


@pytest.mark.parametrize("model_type,res_stem,img", RETRAIN_CASES)
def test_cdarts_retrain_matches_jax(model_type, res_stem, img):
    """CDARTSRetrain on each stem (init 4): the JAX package's
    `convert_cdarts_retrain` reads the port's state_dict (the released
    ModelTest names) and the port's bridge is its exact inverse; logits and
    the three `forward_pyramid` features within 1e-5 of JAX's."""
    groups = 4 if res_stem else 3
    g = [D.EXAMPLE_GENOTYPE] * groups
    m = seeded(D.CDARTSRetrain(g, model_type, res_stem, init_channels=4, num_classes=7)).eval()
    variables = convert_cdarts_retrain({k: _np(v) for k, v in m.state_dict().items()}, g,
                                       model_type=model_type, res_stem=res_stem)
    back = load.cdarts_retrain_state_dict_from_jax(variables, g, model_type, res_stem)
    sd = m.state_dict()
    assert set(back) == set(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd if not k.endswith("num_batches_tracked"))
    jm = JD.CDARTSRetrain(genotypes=tuple(g), model_type=model_type, res_stem=res_stem,
                          init_channels=4, num_classes=7)
    x = images(6, 2, img)
    with torch.no_grad():
        got = m(torch.from_numpy(x))
        pyr = m.forward_pyramid(torch.from_numpy(x))
    want, jpyr = jax.jit(lambda v, x: (jm.apply(v, x), jm.apply(
        v, x, method=JD.CDARTSRetrain.forward_pyramid)))(variables, jnp.asarray(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5, rtol=1e-5)
    assert len(pyr) == len(jpyr) == 3
    for a, b in zip(pyr, jpyr):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=1e-5, rtol=1e-5)


def test_load_cdarts_retrain_reads_a_released_layout(tmp_path):
    """`load_cdarts_retrain` on a .pth the test writes ({"model": state_dict}
    in the released names, one extra key) and a cells JSON of genotype
    strings: the port's logits equal JAX's `load_cdarts_retrain` on the same
    files within 1e-5; a file missing a key raises."""
    g = [D.EXAMPLE_GENOTYPE, D.parse_genotype(np_alphas(1, 14)), D.EXAMPLE_GENOTYPE]
    cells = {str(i): repr(x) for i, x in enumerate(g)}
    src = seeded(D.CDARTSRetrain(g, init_channels=4, num_classes=6))
    sd = {k: v.clone() for k, v in src.state_dict().items()}
    sd["aux_head.classifier.weight"] = torch.zeros(3, 3)
    torch.save({"model": sd}, tmp_path / "ckpt.pth")
    (tmp_path / "cells.json").write_text(json.dumps(cells))
    m = load.load_cdarts_retrain(str(tmp_path / "ckpt.pth"), str(tmp_path / "cells.json"),
                                 device="cpu", init_channels=4, num_classes=6)
    jm, variables = jax_load_cdarts_retrain(str(tmp_path / "ckpt.pth"),
                                            str(tmp_path / "cells.json"), init_channels=4,
                                            num_classes=6)
    x = images(7, 2, 64)
    with torch.no_grad():
        got = m(torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x))),
                               atol=1e-5, rtol=1e-5)
    del sd["fc.bias"]
    with pytest.raises(RuntimeError):
        load.load_cdarts_retrain(sd, cells, device="cpu", init_channels=4, num_classes=6)


@pytest.mark.parametrize("name", ["cdarts_retrain_imagenet", "cdarts_retrain_cifar",
                                  "darts_augment_cifar"])
def test_registered_param_counts_equal_jax(name):
    """The registered discrete networks build the JAX package's parameter
    count (params and BN statistics, BN counters aside); the search
    network's tree is held leaf by leaf by the bridge tests and the
    golden."""
    x = jnp.zeros((1, 32, 32, 3))
    kw = ({"genotype": D.EXAMPLE_GENOTYPE} if name == "darts_augment_cifar"
          else {"genotypes": [D.EXAMPLE_GENOTYPE] * 3})
    args = (x,)
    m = create_model(name, device="cpu", **kw)
    jm = jax_create_model(name, **kw)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), *args))
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    n_port = sum(v.numel() for k, v in m.state_dict().items()
                 if not k.endswith("num_batches_tracked"))
    assert n_port == n_jax


def test_speed_test_runs_search_networks_through_their_steps():
    """`cli.speed_test` builds the discrete networks from the example
    genotypes, runs a search network at seeded alphas (`forward_fn`) and
    times it with `--train` through the searcher's weight step
    (`supernet_step`), whose first update equals `make_weight_step`'s with
    the same optimizer and alphas."""
    from cream_tpu_torch.cli import speed_test
    from cream_tpu_torch.models import nasbench201 as N
    from cream_tpu_torch.nas.cdarts import make_weight_step
    from cream_tpu_torch.train import TrainState
    from cream_tpu_torch.train.optim import make_sgd
    assert speed_test.genotype_kwargs("cdarts_retrain_cifar", {}) == {
        "genotypes": [D.EXAMPLE_GENOTYPE] * 3}
    assert speed_test.genotype_kwargs("nasbench201_infer", {}) == {"genotype": N.EXAMPLE_ARCH}
    assert speed_test.genotype_kwargs("darts_augment_cifar", {"genotype": "g"}) == {}
    assert speed_test.genotype_kwargs("darts_search_cifar", {}) == {}
    x = torch.from_numpy(images(9, 2))
    batch = {"image": x, "label": torch.tensor([0, 3])}
    losses = []
    for route in ("speed_test", "searcher"):
        m = _port_search()
        a = speed_test.search_alphas(m)
        assert speed_test.search_alphas(D.AugmentCNN(D.EXAMPLE_GENOTYPE)) is None
        with torch.no_grad():
            assert speed_test.forward_fn(m.eval())(x).shape == (2, 5)
        if route == "speed_test":
            state = TrainState(m, make_sgd(0.05))
            losses.append(speed_test.supernet_step(m)(state, batch, 0)[1]["loss"])
        else:
            losses.append(make_weight_step(m, make_sgd(0.05))(a, batch)["loss"])
    assert torch.equal(*losses)


# ---- full-width goldens ----

GOLDEN_GENOTYPES = [D.EXAMPLE_GENOTYPE] * 3


def retrain_golden_inputs():
    return images(INPUT_SEED, 2, 224)


def search_golden_inputs():
    rng = np.random.default_rng(INPUT_SEED)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    a = {k: (1e-1 * rng.standard_normal((14, 8))).astype(np.float32)
         for k in ("normal", "reduce")}
    return x, a, rng.integers(0, 10, 2)


def test_full_width_cdarts_retrain_imagenet_golden():
    """cdarts_retrain_imagenet (init 48, 224 px, 5/5/4 cells) on seeded
    weights: fp32 B=2 logits within 1e-3 of the JAX package's stored
    logits."""
    g = np.load(RETRAIN_GOLDEN)
    m = create_model("cdarts_retrain_imagenet", genotypes=GOLDEN_GENOTYPES, device="cpu")
    seeded(m, int(g["weight_seed"]))
    with torch.no_grad():
        got = m(torch.from_numpy(retrain_golden_inputs())).numpy()
    assert np.abs(got - g["logits"]).max() <= 1e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_full_width_darts_search_golden(dtype):
    """darts_search_cifar (C 16, 8 layers, 4 nodes, 32 px) on seeded weights
    and seeded alphas, eval mode, against the JAX package's run in float64:
    B=2 logits within 1e-3 and the CE loss's alpha grads within 1e-3 of
    their largest |value| (fp32; measured 1.4e-4) and within 1e-6 of them
    (float64)."""
    g = np.load(SEARCH_GOLDEN)
    m = create_model("darts_search_cifar", device="cpu", dtype=dtype)
    seeded(m, int(g["weight_seed"])).to(dtype)
    tol = 1e-3 if dtype == torch.float32 else 1e-6
    x, a, y = search_golden_inputs()
    x = x.astype(np.float64) if dtype == torch.float64 else x
    ta = {k: torch.tensor(v, requires_grad=True, dtype=dtype) for k, v in a.items()}
    logits = m(torch.from_numpy(x), ta["normal"], ta["reduce"])
    torch.nn.functional.cross_entropy(logits, torch.from_numpy(y)).backward()
    assert np.abs(_np(logits) - g["logits"]).max() <= tol
    for k in ("normal", "reduce"):
        want = g[f"grad_{k}"]
        assert np.abs(_np(ta[k].grad) - want).max() <= tol * np.abs(want).max()


def write_goldens():
    DATA.mkdir(parents=True, exist_ok=True)
    m = seeded(create_model("cdarts_retrain_imagenet", genotypes=GOLDEN_GENOTYPES,
                            device="cpu"))
    variables = convert_cdarts_retrain({k: _np(v) for k, v in m.state_dict().items()},
                                       GOLDEN_GENOTYPES)
    jm = jax_create_model("cdarts_retrain_imagenet", genotypes=GOLDEN_GENOTYPES)
    logits = jax.jit(jm.apply)(variables, jnp.asarray(retrain_golden_inputs()))
    np.savez(RETRAIN_GOLDEN, logits=np.asarray(logits), weight_seed=WEIGHT_SEED,
             input_seed=INPUT_SEED)
    # the search network in float64: JAX's fp32 alpha grads on the CPU sit
    # well above the port's fp32 rounding (tests/test_torch_cdarts.py)
    jax.config.update("jax_enable_x64", True)
    m = seeded(create_model("darts_search_cifar", device="cpu"))
    jm = jax_create_model("darts_search_cifar", dtype=jnp.float64)
    x, a, y = search_golden_inputs()
    template = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.asarray(x),
                                              a["normal"], a["reduce"]))
    variables = jax.tree_util.tree_map(lambda t: np.asarray(t, np.float64), jax_variables_from_port(
        m.state_dict(), template, load.darts_search_state_dict_from_jax))

    def loss(an, ar):
        lg = jm.apply(variables, jnp.asarray(x, jnp.float64), an, ar)
        return optax.softmax_cross_entropy_with_integer_labels(lg, jnp.asarray(y)).mean(), lg
    (_, lg), (gn, gr) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        *(jnp.asarray(a[k], jnp.float64) for k in ("normal", "reduce")))
    np.savez(SEARCH_GOLDEN, logits=np.asarray(lg), grad_normal=np.asarray(gn),
             grad_reduce=np.asarray(gr), weight_seed=WEIGHT_SEED, input_seed=INPUT_SEED,
             image=x, label=y, alphas_normal=a["normal"], alphas_reduce=a["reduce"])


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    write_goldens()
