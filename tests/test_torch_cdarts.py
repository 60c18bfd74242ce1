"""cream_tpu_torch's staged CDARTS search (`nas/cdarts_stage.py`: the
controller's paths, the super <-> nas copies, `transfer_variables`, the
three step functions, `MultiStageSearcher`; `cli/search_cdarts.py`) against
the JAX package's, on shared seeded weights and numpy-seeded inputs (fp32).

Weights: `seeded_state_dict` or `init_weights` on the port's controller,
carried to JAX through `zoo.load.cdarts_controller_state_dict_from_jax`
inverted (`torch_port_bridges`). The forward paths, the copies and
`transfer_variables` run live against JAX at a narrow size (3 layers of one
cell, 2 nodes, C 4, 32 px). JAX compiles each step function of a
controller in seconds and recompiles them at every discretization (its
narrow staged run takes minutes on the CPU), so the steps and the staged run
are held to records the JAX package wrote with the same draws (`__main__`):
  cdarts_steps_narrow_seed0.npz   3 pretrain, 3 joint and 3 super-weight
                                  steps: losses, per-tensor grad norms,
                                  alpha grads and alphas
  cdarts_stage_run_seed0.json     a narrow MultiStageSearcher.run: its
                                  genotype history and final alphas, the
                                  alphas and each fresh controller drawn by
                                  the port's seeded functions
  cdarts_joint_step_seed0.npz     one full-width joint step (StageSearchConfig
                                  widths, B=2): loss, grad norm, alpha grads
Regenerate them with
    PYTHONPATH=.:tests python tests/test_torch_cdarts.py
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from cream_tpu.models import darts as JD
from cream_tpu.nas import cdarts_stage as JS
from cream_tpu_torch.cli import search_cdarts
from cream_tpu_torch.models import darts as D
from cream_tpu_torch.nas import cdarts_stage as S
from cream_tpu_torch.train.optim import global_norm
from cream_tpu_torch.zoo.load import cdarts_controller_state_dict_from_jax, seeded_state_dict
from torch_port_bridges import assert_bridge_inverts, jax_variables_from_port
from torch_threads import one_torch_thread_module  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
DATA = REPO / "tests" / "data" / "torch_port"
STEPS_GOLDEN = DATA / "cdarts_steps_narrow_seed0.npz"
RUN_GOLDEN = DATA / "cdarts_stage_run_seed0.json"
JOINT_GOLDEN = DATA / "cdarts_joint_step_seed0.npz"
NARROW = dict(num_classes=5, layer_num=3, cells_per_layer=1, n_nodes=2, C=4, aux_pool_size=4)
RUN_CFG = dict(layer_num=2, cells_per_layer=1, n_nodes=2, C=4, pretrain_epochs=1,
               search_iters=1, steps_per_iter=2, aux_pool_size=4)
bridge = cdarts_controller_state_dict_from_jax


def _np(t):
    return t.detach().cpu().numpy().copy()


def images(seed, batch=2, size=32):
    return np.random.default_rng(seed).standard_normal((batch, size, size, 3)).astype(np.float32)


def np_alphas(seed, n_nodes=2, scale=1.0, beta_scale=0.5):
    rng = np.random.default_rng(seed)
    e = D.n_alpha_edges(n_nodes)
    a = {k: (scale * rng.standard_normal((e, 8))).astype(np.float32) for k in ("normal", "reduce")}
    a.update({f"beta_{k}": (beta_scale * rng.standard_normal(e)).astype(np.float32)
              for k in ("normal", "reduce")})
    return a


def torch_alphas(a):
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in a.items()}


def genotypes_for(seed, n_nodes=2, layers=3):
    return [S.parse_stage_genotype(np_alphas(seed + i, n_nodes), n_nodes) for i in range(layers)]


def port_controller(genotypes, seed=0, **kw):
    m = S.CDARTSController(genotypes, **{**NARROW, **kw})
    m.load_state_dict(seeded_state_dict(m, seed))
    return m


def jax_controller(genotypes, **kw):
    return JS.CDARTSController(genotypes=tuple(genotypes), **{**NARROW, **kw})


def jax_template(jm, alphas, size=32):
    return jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((2, size, size, 3)),
                                          alphas, init_all=True))


def to_jax(m, jm, alphas, size=32):
    return jax_variables_from_port(m.state_dict(), jax_template(jm, alphas, size), bridge)


# ---- the controller ----

PATHS = [dict(layer_idx=0, super_flag=True), dict(layer_idx=2, super_flag=True),
         dict(super_flag=False), dict(pretrain=True)]


def test_controller_paths_match_jax():
    """The super path at layer_idx 0 and 2, the nas path and the pretrain
    path: logits and the ensemble (or aux) logits within 1e-5 of JAX's, eval
    mode, and the nas path in train mode; the bridge inverts bit for bit."""
    g = genotypes_for(3)
    m = port_controller(g).eval()
    jm = jax_controller(g)
    a = np_alphas(4)
    variables = to_jax(m, jm, a)
    assert_bridge_inverts(m.state_dict(), variables, bridge)
    x = images(5)
    for kw in PATHS + [dict(super_flag=False, train=True)]:
        train = kw.pop("train", False)
        fn = jax.jit(lambda v, x, a: jm.apply(v, x, a, train=train, **kw,
                                              mutable=["batch_stats"] if train else False))
        want = fn(variables, jnp.asarray(x), a)
        want = want[0] if train else want
        with torch.no_grad():
            got = m.train(train)(torch.from_numpy(x), torch_alphas(a), **kw)
        for p, q in zip(got, want):
            np.testing.assert_allclose(_np(p), np.asarray(q), atol=1e-5, rtol=1e-5,
                                       err_msg=str(kw))


def test_controller_heads_follow_the_layer_count():
    """Aux heads after layers layer_num-3 and layer_num-2 where they exist:
    both at 3 layers, only `distill_aux_head2` at 2, as in JAX's tree."""
    for layers, want in ((3, {"distill_aux_head1", "distill_aux_head2"}),
                         (2, {"distill_aux_head2"})):
        g = genotypes_for(1, layers=layers)
        names = {n for n, _ in S.CDARTSController(g, **{**NARROW, "layer_num": layers})
                 .named_children() if n.startswith("distill")}
        tree = jax_template(jax_controller(g, layer_num=layers), np_alphas(0))["params"]
        assert names == want == {k for k in tree if k.startswith("distill")}


def test_jax_aux_head_pads_its_2x2_conv():
    """A JAX-side difference kept (ROADMAP Queue 3): JAX's DistillHead
    builds its 2x2 conv with flax's default 'SAME' padding, so a map pooled
    to 1x1 still gives logits (the reference's unpadded conv has no output
    there); the port pads as JAX does and matches it within 1e-5."""
    x = np.random.default_rng(3).standard_normal((2, 6, 6, 8)).astype(np.float32)
    jm = JS.DistillHead(6, 5)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.asarray(x)))
    assert shapes["params"]["conv2"]["kernel"].shape == (2, 2, 128, 768)
    port = S.DistillHead(8, 6, 5)
    port.load_state_dict(seeded_state_dict(port, 2))
    f = port.features
    head = {"params": {"conv1": {"kernel": _np(f[2].weight).transpose(2, 3, 1, 0)},
                       "conv2": {"kernel": _np(f[5].weight).transpose(2, 3, 1, 0)},
                       "classifier": {"kernel": _np(port.classifier.weight).T,
                                      "bias": _np(port.classifier.bias)}},
            "batch_stats": {b: {"mean": _np(f[i].running_mean), "var": _np(f[i].running_var)}
                            for b, i in (("bn1", 3), ("bn2", 6))}}
    want = jm.apply(head, jnp.asarray(x))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5, rtol=1e-5)
    with pytest.raises(RuntimeError):
        torch.nn.functional.conv2d(torch.zeros(1, 128, 1, 1), port.features[5].weight)


def test_copies_match_jax():
    """copy_super_to_nas and copy_nas_to_super over every layer: the port's
    state_dict after each equals the JAX package's functional copy carried
    back by the bridge, bit for bit (the nas weights moved off the super
    ones before the copy back)."""
    g = genotypes_for(6)
    m = port_controller(g)
    jm = jax_controller(g)
    variables = to_jax(m, jm, np_alphas(0))
    S.copy_super_to_nas(m, [0, 1, 2])
    jv = JS.copy_super_to_nas(variables, jm, [0, 1, 2])
    assert_bridge_inverts(m.state_dict(), jv, bridge)
    with torch.no_grad():
        for n, p in m.nas_layers.named_parameters():
            p.add_(0.01 * torch.arange(p.numel()).reshape(p.shape) % 0.1)
    jv = to_jax(m, jm, np_alphas(0))
    S.copy_nas_to_super(m, [1, 2])
    assert_bridge_inverts(m.state_dict(), JS.copy_nas_to_super(jv, jm, [1, 2]), bridge)


def test_transfer_variables_matches_jax():
    """A controller rebuilt for new genotypes in layers 1-2 takes every
    tensor whose name and shape survive, as JAX's `transfer_variables` does
    on the same fresh and old trees (bit for bit)."""
    g_old, g_new = genotypes_for(6), genotypes_for(6)[:1] + genotypes_for(20)[1:]
    old, new = port_controller(g_old, 1), port_controller(g_new, 2)
    jold = to_jax(old, jax_controller(g_old), np_alphas(0))
    jnew = to_jax(new, jax_controller(g_new), np_alphas(0))
    S.transfer_variables(new, old)
    assert_bridge_inverts(new.state_dict(), JS.transfer_variables(jnew, jold), bridge)


# ---- the steps (against the JAX package's record) ----

class Recording:
    """An optimizer that keeps the grads it is handed."""

    def __init__(self, inner):
        self.inner, self.grads = inner, None

    def step(self, params, grads):
        self.grads = {k: v.detach().clone() for k, v in grads.items()}
        self.inner.step(params, grads)


def step_batches():
    rng = np.random.default_rng(30)
    return [{"image": images(31 + i, 4), "label": rng.integers(0, 5, 4)} for i in range(3)]


def run_port_steps(dtype=torch.float32):
    """pretrain x3, joint x3 (layer_idx 1), super weight x3 (layer_idx 1),
    chained from seeded weights, computing in `dtype`: per step the loss,
    the per-tensor grad norms, and for the joint steps the alpha grads and
    alphas after."""
    from cream_tpu_torch.nas.cdarts import make_alpha_adam
    from cream_tpu_torch.train.optim import make_sgd
    g = genotypes_for(6)
    m = port_controller(g, dtype=dtype).to(dtype)
    alphas = {k: v.to(dtype) for k, v in torch_alphas(np_alphas(7)).items()}
    w_opt, nas_opt = Recording(make_sgd(0.05)), Recording(make_sgd(0.05))
    alpha_opt = Recording(make_alpha_adam(3e-4))
    pre = S.make_pretrain_step(m, w_opt)
    joint = S.make_joint_search_step(m, nas_opt, alpha_opt, 1.0, 2.0, "kl", 1e-3)
    sup = S.make_super_weight_step(m, w_opt)
    out = {}
    batches = [{"image": torch.from_numpy(b["image"]).to(dtype),
                "label": torch.from_numpy(b["label"])} for b in step_batches()]
    for i, b in enumerate(batches):
        out[f"pretrain_{i}"] = (float(pre(alphas, b)), w_opt.grads)
    for i, b in enumerate(batches):
        loss, acc = joint(alphas, b, 1)
        out[f"joint_{i}"] = (float(loss), nas_opt.grads)
        out[f"joint_{i}_alpha_grads"] = alpha_opt.grads
        out[f"joint_{i}_alphas"] = {k: v.clone() for k, v in alphas.items()}
    for i, b in enumerate(batches):
        out[f"super_{i}"] = (float(sup(alphas, b, 1)), w_opt.grads)
    return m, out


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_steps_match_jax_record(dtype):
    """3 steps of each step function chained (pretrain, joint at layer_idx
    1 with reg 1e-3, super weight at layer_idx 1; SGD 0.05 / 0.9 on the
    weights, Adam 3e-4 b1 0.5 on the alphas) against the JAX package's step
    functions run in float64 on the same weights, alphas and batches: each
    loss within 1e-4, each tensor's grad norm within 1e-3 of JAX's
    (relative, above a 1e-6 floor; a param a step does not reach has grad
    0 in both), the alpha grads within 1e-3 of their largest |value| and
    the alphas within 1e-5. The port in float64 runs all nine steps; in
    fp32 the first (the grad-norm floor 1e-4 of the step's largest): from
    there fp32 rounding grows through the chain, by how much depending on
    the CPU's thread count (the third pretrain step's stem grad 1.2e-3 off
    at one thread, 2.6e-6 at the default; the super-weight steps' up to
    6e-2); a fp32 JAX run drifts the same way, its first step's grads
    already 1.9% off float64 at one op, where the port's sit at 1e-6."""
    rec = np.load(STEPS_GOLDEN)
    _, out = run_port_steps(dtype)
    if dtype == torch.float32:
        out = {k: v for k, v in out.items() if k == "pretrain_0"}
    for key, val in out.items():
        if key.endswith("_alphas"):
            for k, v in val.items():
                np.testing.assert_allclose(_np(v), rec[f"{key}/{k}"], atol=1e-5)
        elif key.endswith("_alpha_grads"):
            for k, v in val.items():
                want = rec[f"{key}/{k}"]
                assert np.abs(_np(v) - want).max() <= 1e-3 * np.abs(want).max() + 1e-8, key
        else:
            loss, grads = val
            assert abs(loss - float(rec[f"{key}/loss"])) <= 1e-4, (key, loss)
            assert sorted(grads) == rec["names"].tolist()
            floor = 1e-6 if dtype == torch.float64 else 1e-4 * rec[f"{key}/norms"].max()
            for name, want in zip(rec["names"], rec[f"{key}/norms"]):
                got = float(grads[name].norm())
                assert abs(got - want) <= 1e-3 * want + floor, (key, name, got, want)


# ---- the staged run (against the JAX package's record) ----

def run_batches(seed, n=2):
    rng = np.random.default_rng(seed)
    return [{"image": images(seed * 10 + i, 4, 16), "label": rng.integers(0, 10, 4)}
            for i in range(n)]


def stage_draws():
    """The seeded draws both runs take: the i-th alpha set from numpy seed
    40 + i at DARTS' scale (edge logits 0), the k-th fresh controller from
    `init_weights` on torch seed 100 + k."""
    def alpha_fn(i):
        a = np_alphas(40 + i, RUN_CFG["n_nodes"], 1e-3, 0.0)
        return a
    return alpha_fn, lambda m, k: S.init_weights(m, torch.Generator().manual_seed(100 + k))


def port_stage_run():
    alpha_fn, init_fn = stage_draws()
    counts = {"a": 0, "m": 0}

    def init_alphas(n):
        counts["a"] += 1
        return torch_alphas(alpha_fn(counts["a"] - 1))

    def init_model(m):
        counts["m"] += 1
        init_fn(m, counts["m"] - 1)
    s = S.MultiStageSearcher(S.StageSearchConfig(**RUN_CFG), device="cpu",
                             init_alphas=init_alphas, init_model=init_model)
    tr, va = run_batches(1), run_batches(2)
    to_t = lambda bs: [{k: torch.from_numpy(v) for k, v in b.items()} for b in bs]
    genotypes, history = s.run(lambda: iter(to_t(tr)), lambda: iter(to_t(va)),
                               log=lambda *a: None)
    return s, genotypes, history


def test_stage_run_matches_jax_record():
    """A narrow MultiStageSearcher.run (2 layers of one cell, 2 nodes, C 4,
    2 steps an iter) with the same alpha and controller draws as the JAX
    package's recorded run: the same genotype history and final genotypes,
    the final alphas within 1e-4. The record keeps the smallest gap between
    a node's second and third edge scores over every parse of JAX's run:
    8.4e-7, within 1e-6, so a parse there could go either way on other
    hardware; the port picks JAX's edges."""
    rec = json.loads(RUN_GOLDEN.read_text())
    s, genotypes, history = port_stage_run()
    assert [repr(h["genotype"]) for h in history] == rec["history"]
    assert [repr(g) for g in genotypes] == rec["final_genotypes"]
    for k, v in s.alphas.items():
        np.testing.assert_allclose(_np(v), np.asarray(rec["alphas"][k], np.float32), atol=1e-4)
    assert len(s.timings["discretize"]) == 4 and len(s.timings["joint"]) == 4


# ---- the CLI ----

def test_cli_json_is_read_by_both_packages(tmp_path):
    """`cli.search_cdarts --cpu` at a tiny size writes the JAX CLI's JSON:
    the port builds cdarts_retrain_imagenet from its final genotypes and
    the JAX package reads them as its Genotypes; a JSON written the JAX
    CLI's way from JAX Genotypes builds the port's retrain network."""
    out = tmp_path / "g.json"
    res = search_cdarts.main(["--cpu", "--synthetic", "--layers", "2", "--cells", "1",
                              "--channels", "4", "--nodes", "2", "--steps", "1", "--iters", "1",
                              "--batch-size", "4", "--aux-pool", "4", "--out", str(out)])
    data = json.loads(out.read_text())
    assert data["final_genotypes"] == json.loads(json.dumps(res["final_genotypes"]))
    assert len(data["history"]) == 2
    final = data["final_genotypes"] + data["final_genotypes"][:1]
    jax_g = [JD.Genotype(**d) for d in final]
    m = D.cdarts_retrain_imagenet(final, init_channels=4, num_classes=10, device="cpu")
    assert [D.as_genotype(g) for g in jax_g] == list(m.genotypes)
    with torch.no_grad():
        assert m(torch.zeros(1, 64, 64, 3)).shape == (1, 10)
    jax_json = json.dumps({"final_genotypes": [JS.parse_stage_genotype(
        {k: jnp.asarray(v) for k, v in np_alphas(9 + i, 4).items()})._asdict()
        for i in range(3)]}, default=str)
    m = D.cdarts_retrain_imagenet(json.loads(jax_json)["final_genotypes"], init_channels=4,
                                  device="cpu")
    assert m.genotypes[0] == D.as_genotype(JS.parse_stage_genotype(np_alphas(9, 4)))
    if not torch.cuda.is_available():        # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            search_cdarts.main(["--synthetic", "--out", str(out)])


# ---- the full-width joint step ----

def joint_golden_setup():
    g = [D.EXAMPLE_GENOTYPE] * 3
    m = S.CDARTSController(g)
    m.load_state_dict(seeded_state_dict(m, 0))
    a = np_alphas(1, 4, 1e-3, 0.5)
    rng = np.random.default_rng(1)
    batch = {"image": images(2, 2, 32), "label": rng.integers(0, 10, 2)}
    return g, m, a, batch


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_full_width_joint_step_golden(dtype):
    """One joint step of the full-width controller (StageSearchConfig's 3
    layers of 2 cells, 4 nodes, C 16, aux pool 6; B=2, layer_idx 1) on
    seeded weights against the JAX package's step run in float64: the port
    in float64 within 1e-6 (loss; grad norm and alpha grads relative to
    their largest); in fp32 the loss within 1e-4, the grad norm within 1e-3
    and the alpha grads within 1e-2 of their largest |value| (measured up to
    1.7e-3: the batch of 2 puts BN-cancelled terms in the grads; JAX's own
    fp32 step sits 1.7e-3 off too)."""
    from cream_tpu_torch.nas.cdarts import make_alpha_adam
    from cream_tpu_torch.train.optim import make_sgd
    rec = np.load(JOINT_GOLDEN)
    g, m, a, batch = joint_golden_setup()
    if dtype == torch.float64:
        m = S.CDARTSController(g, dtype=dtype)
        m.load_state_dict(seeded_state_dict(m, 0))
        m = m.to(dtype)
    tol = (1e-6, 1e-6, 1e-6) if dtype == torch.float64 else (1e-4, 1e-3, 1e-2)
    nas_opt, alpha_opt = Recording(make_sgd(0.05)), Recording(make_alpha_adam())
    step = S.make_joint_search_step(m, nas_opt, alpha_opt, 1.0, 2.0, "kl", 1e-3)
    loss, _ = step({k: v.to(dtype) for k, v in torch_alphas(a).items()},
                   {"image": torch.from_numpy(batch["image"]).to(dtype),
                    "label": torch.from_numpy(batch["label"])}, 1)
    assert abs(float(loss) - float(rec["loss"])) <= tol[0]
    gn = float(global_norm(nas_opt.grads.values()))
    assert abs(gn - float(rec["grad_norm"])) <= tol[1] * float(rec["grad_norm"])
    for k, v in alpha_opt.grads.items():
        want = rec[f"alpha_grad/{k}"]
        assert np.abs(_np(v) - want).max() <= tol[2] * np.abs(want).max(), k


# ---- the records ----

def recording_tx(inner):
    """An optax transform whose state also carries the last grads."""
    def init(p):
        return inner.init(p), jax.tree_util.tree_map(jnp.zeros_like, p)

    def update(g, s, p=None):
        u, s0 = inner.update(g, s[0], p)
        return u, (s0, g)
    return optax.GradientTransformation(init, update)


def grad_norms(grads, stats):
    """Per-tensor grad norms in the port's sorted param names."""
    sd = bridge({"params": grads, "batch_stats": stats})
    names = sorted(k for k in sd if "running" not in k and not k.endswith("num_batches_tracked"))
    return names, np.array([np.linalg.norm(sd[k].numpy().ravel()) for k in names], np.float64)


def write_steps_record():
    """The JAX package's steps in float64 (its CPU fp32 grads sit up to 2%
    off a float64 step at some ops, where the port's fp32 sit at 1e-6:
    measured on the first pretrain step)."""
    jax.config.update("jax_enable_x64", True)
    g = genotypes_for(6)
    m = port_controller(g)
    jm = jax_controller(g, dtype=jnp.float64)
    a = {k: jnp.asarray(v, jnp.float64) for k, v in np_alphas(7).items()}
    variables = jax.tree_util.tree_map(lambda t: np.asarray(t, np.float64), to_jax(m, jm, a))
    p, st = variables["params"], variables["batch_stats"]
    w_tx = recording_tx(optax.sgd(0.05, momentum=0.9))
    nas_tx = recording_tx(optax.sgd(0.05, momentum=0.9))
    alpha_tx = recording_tx(optax.adam(3e-4, b1=0.5, b2=0.999))
    pre = JS.make_pretrain_step(jm, w_tx)
    joint = JS.make_joint_search_step(jm, nas_tx, alpha_tx, 1.0, 2.0, "kl", 1e-3)
    sup = JS.make_super_weight_step(jm, w_tx)
    w_opt, nas_opt, alpha_opt = w_tx.init(p), nas_tx.init(p), alpha_tx.init(a)
    rec = {}
    batches = [{"image": jnp.asarray(b["image"], jnp.float64), "label": jnp.asarray(b["label"])}
               for b in step_batches()]
    for i, b in enumerate(batches):
        p, st, w_opt, loss = pre(p, st, w_opt, a, b)
        rec[f"pretrain_{i}/loss"] = float(loss)
        rec["names"], rec[f"pretrain_{i}/norms"] = grad_norms(w_opt[1], st)
    for i, b in enumerate(batches):
        p, st, nas_opt, a, alpha_opt, loss, _ = joint(p, st, nas_opt, a, alpha_opt, b, 1)
        rec[f"joint_{i}/loss"] = float(loss)
        rec["names"], rec[f"joint_{i}/norms"] = grad_norms(nas_opt[1], st)
        rec.update({f"joint_{i}_alpha_grads/{k}": np.asarray(v) for k, v in alpha_opt[1].items()})
        rec.update({f"joint_{i}_alphas/{k}": np.asarray(v) for k, v in a.items()})
    for i, b in enumerate(batches):
        p, st, w_opt, loss = sup(p, st, w_opt, a, b, 1)
        rec[f"super_{i}/loss"] = float(loss)
        rec["names"], rec[f"super_{i}/norms"] = grad_norms(w_opt[1], st)
    np.savez(STEPS_GOLDEN, **rec)


def write_run_record():
    alpha_fn, init_fn = stage_draws()
    real_init, real_transfer = JS.init_stage_alphas, JS.transfer_variables
    counts = {"a": 0, "m": 0}
    box = {}

    def port_fresh(genotypes, like):
        cfg = RUN_CFG
        m = S.CDARTSController(genotypes, 10, cfg["layer_num"], cfg["cells_per_layer"],
                               cfg["n_nodes"], cfg["C"], aux_pool_size=cfg["aux_pool_size"])
        init_fn(m, counts["m"])
        counts["m"] += 1
        return jax_variables_from_port(m.state_dict(), like, bridge)

    def init_alphas(key, n):
        counts["a"] += 1
        return {k: jnp.asarray(v) for k, v in alpha_fn(counts["a"] - 1).items()}

    def transfer(new, old):
        return real_transfer(port_fresh(box["s"].model.genotypes, new), old)

    JS.init_stage_alphas, JS.transfer_variables = init_alphas, transfer
    try:
        cfg = JS.StageSearchConfig(**RUN_CFG)
        tr, va = run_batches(1), run_batches(2)
        to_j = lambda bs: [{k: jnp.asarray(v) for k, v in b.items()} for b in bs]
        s = JS.MultiStageSearcher(cfg, jax.random.key(0), to_j(va)[0])
        box["s"] = s
        s.variables = port_fresh(s.model.genotypes, jax.device_get(s.variables))
        s._rebuild_steps()
        gaps = []
        real_parse = JS.parse_stage_genotype

        def parse(alphas, n_nodes=4):
            for k in ("normal", "reduce"):
                aw = np.asarray(jax.nn.softmax(alphas[k], -1))
                off = 0
                for i in range(n_nodes):
                    ew = np.asarray(jax.nn.softmax(alphas["beta_" + k][off:off + 2 + i]))
                    rows = aw[off:off + 2 + i].copy()
                    rows[:, JD.PRIMITIVES.index("none")] = -1
                    best = np.sort((ew[:, None] * rows).max(-1))[::-1]
                    if len(best) > 2:
                        gaps.append(best[1] - best[2])
                    off += 2 + i
            return real_parse(alphas, n_nodes)
        JS.parse_stage_genotype = parse
        genotypes, history = s.run(lambda: iter(to_j(tr)), lambda: iter(to_j(va)),
                                   log=lambda *a: None)
    finally:
        JS.init_stage_alphas, JS.transfer_variables = real_init, real_transfer
        JS.parse_stage_genotype = real_parse
    rec = {"history": [repr(D.as_genotype(h["genotype"])) for h in history],
           "final_genotypes": [repr(D.as_genotype(g)) for g in genotypes],
           "alphas": {k: np.asarray(v).tolist() for k, v in s.alphas.items()},
           "min_top2_gap": float(min(gaps))}
    RUN_GOLDEN.write_text(json.dumps(rec))


def write_joint_record():
    """The JAX package's joint step in float64 (see `write_steps_record`)."""
    jax.config.update("jax_enable_x64", True)
    g, m, a, batch = joint_golden_setup()
    jm = JS.CDARTSController(genotypes=tuple(g), dtype=jnp.float64)
    ja = {k: jnp.asarray(v, jnp.float64) for k, v in a.items()}
    variables = jax.tree_util.tree_map(
        lambda t: np.asarray(t, np.float64), jax_variables_from_port(
            m.state_dict(), jax.eval_shape(lambda: jm.init(
                jax.random.key(0), jnp.zeros((2, 32, 32, 3)), ja, init_all=True)), bridge))
    nas_tx = recording_tx(optax.sgd(0.05, momentum=0.9))
    alpha_tx = recording_tx(optax.adam(3e-4, b1=0.5, b2=0.999))
    joint = JS.make_joint_search_step(jm, nas_tx, alpha_tx, 1.0, 2.0, "kl", 1e-3)
    p = variables["params"]
    out = joint(p, variables["batch_stats"], nas_tx.init(p), ja, alpha_tx.init(ja),
                {"image": jnp.asarray(batch["image"], jnp.float64),
                 "label": jnp.asarray(batch["label"])}, 1)
    gp, ga = out[2][1], out[4][1]
    np.savez(JOINT_GOLDEN, loss=float(out[5]), grad_norm=float(optax.global_norm(gp)),
             **{f"alpha_grad/{k}": np.asarray(v, np.float32) for k, v in ga.items()},
             **{f"alphas/{k}": v for k, v in a.items()}, image=batch["image"],
             label=batch["label"], weight_seed=0)


if __name__ == "__main__":
    import sys
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    for name in sys.argv[1:] or ("steps", "run", "joint"):
        {"steps": write_steps_record, "run": write_run_record, "joint": write_joint_record}[name]()
