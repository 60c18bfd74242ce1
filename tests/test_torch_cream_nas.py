"""cream_tpu_torch's Cream (the supernet, the childnets, the FLOPs tables,
the board and the search CLI) against the JAX package's, on shared seeded
weights and numpy-seeded inputs (the train and meta steps:
`test_torch_cream_train.py`).

Weights: `seeded_state_dict` on the port's model (BN statistics away from
0/1), carried to JAX by `cream_tpu.zoo.import_torch.convert_cream_childnet`
(a supernet choice by choice); the port's `zoo.load.cream_state_dict_from_jax`
carries JAX's back. The depthwise 3x3 sites reach K7/K9 on `"fused"`; on
the CPU their wrappers run the plain versions, held here to the library
route.

Regenerate the golden files (JAX fp32 B=2 logits of cream_604 at 224 and
cream_14 at 64) with
    PYTHONPATH=.:tests python tests/test_torch_cream_nas.py
"""
import copy
import functools
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cream_tpu.models import cream as JC
from cream_tpu.models import create_model as jax_create_model
from cream_tpu.nas import cream as jax_nas
from cream_tpu.nas import flops as jax_flops
from cream_tpu.zoo.import_torch import convert_cream_childnet
from cream_tpu.zoo.load import convert_for_model
from cream_tpu_torch.cli import search_cream
from cream_tpu_torch.models import cream as C
from cream_tpu_torch.models import create_model, list_models
from cream_tpu_torch.nas import cream as nas
from cream_tpu_torch.nas import flops
from cream_tpu_torch.nn import layers
from cream_tpu_torch.nn.layers import set_dw_kernel
from cream_tpu_torch.ops import dwconv
from cream_tpu_torch.zoo.load import cream_state_dict_from_jax, seeded_state_dict
from torch_threads import one_torch_thread_module  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
DATA = REPO / "tests" / "data" / "torch_port"
GOLDENS = ("cream_604", "cream_14")
WEIGHT_SEED, INPUT_SEED = 0, 1


def golden_path(name: str) -> Path:
    return DATA / f"{name}_seed0.npz"


def _np(t):
    """A numpy copy (a view would follow the port's in-place updates)."""
    return t.detach().cpu().numpy().copy()


def _np_sd(sd):
    return {k: _np(v) for k, v in sd.items()}


def supernet_to_jax(sd, stages) -> dict:
    """The port's supernet state_dict as the JAX CreamSupernet's variables:
    each choice through `convert_cream_childnet` as a childnet's layers."""
    sd = _np_sd(sd)
    arch = [(0,) * d for _, d, _ in stages]
    out = {"params": {}, "batch_stats": {}}
    for c in range(len(C.CHOICES)):
        csd = {}
        for k, v in sd.items():
            p = k.split(".")
            if p[0] == "blocks" and 1 <= int(p[1]) <= len(stages):
                if int(p[3]) != c:
                    continue
                k = ".".join(p[:3] + p[4:])
            csd[k] = v
        var = convert_cream_childnet(csd, arch)
        for coll in ("params", "batch_stats"):
            for k, v in var[coll].items():
                if k.startswith("stage_"):
                    out[coll].setdefault(k, {})[f"choice_{c}"] = v
                else:
                    out[coll][k] = v
    return out


# ---- FLOPs tables ----

@pytest.mark.parametrize("img", [64, 160, 224])
def test_flops_tables_equal_jax(img):
    stages = ((16, 2, 2), (24, 3, 2), (40, 1, 2), (48, 2, 1), (64, 2, 2))
    for st in (C.SEARCH_STAGES, stages):
        np.testing.assert_array_equal(flops.build_flops_table(img, stages=st),
                                      jax_flops.build_flops_table(img, stages=st))
        assert flops.build_flops_op_dict(img, st) == jax_flops.build_flops_op_dict(img, st)
    table = flops.build_flops_table(img)
    rng = np.random.default_rng(img)
    for _ in range(50):
        arch = rng.integers(-1, 6, table.shape[0])
        assert flops.arch_flops(arch, table) == jax_flops.arch_flops(arch, table)


def test_search_for_layer_equals_jax():
    """search_for_layer over a grid of FLOPs windows (some unsatisfiable,
    some shrinking the resolution) and sized_stages give JAX's."""
    op_dict = flops.build_flops_op_dict(224)
    hits = set()
    for lo in (1e6, 4e6, 15e6, 100e6, 300e6, 500e6):
        for hi in (3e6, 12e6, 50e6, 200e6, 400e6, 600e6, 1e9):
            got = flops.search_for_layer(op_dict, lo, hi)
            assert got == jax_flops.search_for_layer(op_dict, lo, hi), (lo, hi)
            if got[0] is not None:
                assert flops.sized_stages(got[0]) == jax_flops.sized_stages(got[0])
            hits.add(got[1])
    assert 224 in hits and len(hits) >= 3


# ---- narrow supernet and childnets ----

# the eval tests' supernet: 6 searchable layers, a skippable one at index
# 2 (JAX compiles all six choices of every layer, so the depth sets these
# tests' time)
STAGES = ((16, 1, 2), (24, 2, 2), (32, 1, 2), (32, 1, 1), (48, 1, 2))
IMG = 64


def _supernet(seed=3, dtype=torch.float32, stages=STAGES, img=IMG):
    m = C.CreamSupernet(num_classes=10, stages=stages, img_size=img, dtype=dtype, device="cpu")
    m.load_state_dict(seeded_state_dict(m, seed))
    return m.eval(), JC.CreamSupernet(num_classes=10, stages=stages)


@functools.lru_cache(maxsize=None)
def _jax_apply(stages=STAGES, dtype=jnp.float32):
    """One jitted JAX supernet apply a configuration, shared by the tests
    (the path is traced data: one compile serves every path)."""
    return jax.jit(JC.CreamSupernet(num_classes=10, stages=stages, dtype=dtype).apply)


def _images(seed=2, batch=2, size=IMG):
    return np.random.default_rng(seed).standard_normal((batch, size, size, 3)).astype(np.float32)


ARCHS = [[5, 3, -1, 1, 4, 0], [0] * 6, [4, 2, 5, 3, 5, 2], [1, 0, 1, 1, 0, 1]]


@pytest.mark.parametrize("arch", ARCHS)
def test_narrow_supernet_matches_jax(arch):
    """Eval logits of the routed supernet within 1e-5 of JAX's (which runs
    all six choices and selects), -1 skips included; `extract_childnet`
    gives JAX's childnet weights bit for bit and the supernet's logits."""
    m, _ = _supernet()
    x = _images()
    variables = supernet_to_jax(m.state_dict(), STAGES)
    want = np.asarray(_jax_apply()(variables, jnp.asarray(x), jnp.asarray(arch)))
    with torch.no_grad():
        got = m(torch.from_numpy(x), config=arch).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    child = C.extract_childnet(m, arch)
    _, jvars = JC.extract_childnet(variables, arch, num_classes=10, stages=STAGES)
    back = cream_state_dict_from_jax(jvars)
    sd = child.state_dict()
    assert set(back) == set(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd if not k.endswith("num_batches_tracked"))
    with torch.no_grad():
        assert torch.equal(child(torch.from_numpy(x)), torch.from_numpy(got))


@pytest.mark.parametrize("quirk", [False, True])
def test_narrow_childnet_and_pyramid_match_jax(quirk):
    """A childnet with single-layer stages, with and without
    `released_quirk` (those stages take STAGE_DEFAULTS), logits and the
    stride-8/16/32 pyramid within 1e-5 of JAX's."""
    arch = ((3,), (1, 4), (2,), (5,), (3,))
    m = C.CreamChildNet(arch, num_classes=10, stages=STAGES, released_quirk=quirk,
                        img_size=IMG, device="cpu")
    m.load_state_dict(seeded_state_dict(m, 6))
    m.eval()
    jm = JC.CreamChildNet(arch=arch, num_classes=10, stages=STAGES, released_quirk=quirk)
    variables = convert_cream_childnet(_np_sd(m.state_dict()), arch)
    x = _images(4)
    with torch.no_grad():
        got = m(torch.from_numpy(x)).numpy()
        pyr = m.forward_pyramid(torch.from_numpy(x))
    np.testing.assert_allclose(got, np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x))),
                               atol=1e-5, rtol=1e-5)
    jpyr = jax.jit(lambda v, x: jm.apply(v, x, method=JC.CreamChildNet.forward_pyramid))(
        variables, jnp.asarray(x))
    assert len(pyr) == len(jpyr) == 3
    for a, b in zip(pyr, jpyr):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-5)
    assert [p.shape[1] for p in pyr] == [IMG // 8, IMG // 16, IMG // 32]
    k = m.blocks[1][0].conv_dw.kernel_size[0]
    assert k == (C.STAGE_DEFAULTS[0][0] if quirk else C.CHOICES[3][0])


def test_narrow_bf16_matches_jax():
    """bf16 compute, fp32 params: within 8 bf16 ulps of JAX's bf16 at the
    largest |logit| (BN in the compute dtype, 1x1 convs as GEMMs)."""
    arch = ARCHS[0]
    m, _ = _supernet(dtype=torch.bfloat16)
    x = np.array(jnp.asarray(_images(5)).astype(jnp.bfloat16).astype(jnp.float32))
    want = np.asarray(_jax_apply(STAGES, jnp.bfloat16)(
        supernet_to_jax(m.state_dict(), STAGES), jnp.asarray(x), jnp.asarray(arch)),
        np.float32)
    with torch.no_grad():
        got = m(torch.from_numpy(x), config=arch).float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert np.abs(got - want).max() <= 8 * ulp, (np.abs(got - want).max(), ulp)


def test_board_and_sampling_equal_jax():
    """sample_architecture's draws (with and without the board's op
    probabilities), the board's admission, order and op probabilities, and
    the top-1 teacher pick equal JAX's."""
    rng, jrng = np.random.default_rng(0), np.random.default_rng(0)
    board = nas.PrioritizedBoard(pool_size=3, meta_sta_epoch=0)
    jboard = jax_nas.PrioritizedBoard(pool_size=3, meta_sta_epoch=0)
    for t in range(12):
        prob, jprob = board.op_probability(), jboard.op_probability()
        assert (prob is None and jprob is None) or np.array_equal(prob, jprob)
        a = nas.sample_architecture(rng, [2, 3, 1], prob=prob)
        b = jax_nas.sample_architecture(jrng, [2, 3, 1], prob=jprob)
        assert np.array_equal(a, b)
        prec, fl = float(rng.uniform(0, 100)), float(jrng.uniform(0, 100))
        assert board.update(1 + t % 2, prec, fl, a, None, None) == \
            jboard.update(1 + t % 2, prec, fl, b, None, None)
    assert [e.prec1 for e in board.board] == [e.prec1 for e in jboard.board]
    assert board.select_teacher(None, None, None)[0] == 0.5
    assert np.array_equal(board.select_teacher(None, None, None)[1],
                          jboard.select_teacher(None, None, None)[1])


# ---- the depthwise kernels on Cream's route ----

def test_fused_route_plain_versions_equal_the_library_route():
    """`set_dw_kernel(model, "fused")` on CPU tensors runs K7/K9's plain
    versions at every depthwise 3x3 site of the path: the logits, loss and
    every grad of a train-mode forward within 1e-5 of the largest of the
    library route's (the largest grad over all tensors: the BN-cancelled
    grads of the first blocks are float noise)."""
    m, _ = _supernet()
    arch = ARCHS[3]                          # a k3 choice at every layer
    rng = np.random.default_rng(50)
    x = rng.standard_normal((8, IMG, IMG, 3)).astype(np.float32)
    y = rng.integers(0, 10, 8)
    out = {}
    for route in ("library", "fused"):
        model = copy.deepcopy(m)
        set_dw_kernel(model, route)
        assert all(b.dw_kernel == route for b in model.modules() if hasattr(b, "dw_kernel"))
        model.train()
        loss = torch.nn.functional.cross_entropy(model(torch.from_numpy(x), config=arch),
                                                 torch.from_numpy(y))
        params = dict(model.named_parameters())
        grads = torch.autograd.grad(loss, list(params.values()), materialize_grads=True)
        out[route] = (loss.detach(), dict(zip(params, grads)))
    np.testing.assert_allclose(float(out["fused"][0]), float(out["library"][0]), rtol=1e-6)
    scale = max(float(g.abs().max()) for g in out["library"][1].values())
    for k, g in out["library"][1].items():
        assert (out["fused"][1][k] - g).abs().max() <= 1e-5 * scale, k


def test_every_cream_depthwise_site_takes_the_kernels():
    """Every depthwise 3x3 site of a 224² path (`dw3x3_sites`: the
    depthwise-separable block and the k3 choices, 16·e to 192·e channels)
    passes K7's or K9's shape rule, so `"fused"` refuses none; K7/K8's and
    K9's tile plans cover every output once at those shapes (B = 2); a map
    K9 refuses (odd W) runs the library conv and is counted in
    `layers.DW_REFUSED`."""
    sites = C.dw3x3_sites(batch=2)
    assert sum(s == 2 for s, _ in sites) == 8 and len(sites) == 19
    for stride, shape in sites:
        assert dwconv.supports_fused(shape) if stride == 1 else dwconv.supports_fused_s2(shape)
        B, H, W, Cc = shape
        for dtype in (torch.float32, torch.bfloat16):
            if stride == 1:
                for backward in (False, True):
                    plan = dwconv.tile_plan(shape, dtype, backward)
                    count = np.zeros((B, H, W, Cc // plan.cb), np.int32)
                    for (_, cs), b, rows, cols, _ in dwconv.tile_spans(shape, plan):
                        count[b, rows.start:rows.stop, cols.start:cols.stop, cs] += 1
                    assert (count == 1).all(), (shape, plan)
            else:
                plan = dwconv.tile_plan_s2(shape, dtype)
                assert dwconv.s2_staged_bytes(plan, dtype) <= 96 * 1024
                count = np.zeros((B, H, W, Cc // plan.cb), np.int32)
                for (_, cs), b, _, _, dx_rows, dx_cols, _ in dwconv.tile_spans_s2(shape, plan):
                    count[b, dx_rows.start:dx_rows.stop, dx_cols.start:dx_cols.stop, cs] += 1
                assert (count == 1).all(), (shape, plan)
    block = C.InvertedResidual(8, 8, 3, 4, stride=2, dw_kernel="fused", device="cpu")
    layers.DW_REFUSED.clear()
    with torch.no_grad():
        block.eval()(torch.zeros(1, 6, 5, 8))
    assert layers.DW_REFUSED == {("fused", 2, (1, 6, 5, 32)): 1}
    layers.DW_REFUSED.clear()


@pytest.mark.parametrize("case", ["supernet", "cream_14", "cream_481"])
def test_path_sites_are_the_routes_a_forward_takes(case, monkeypatch):
    """`dw3x3_path_sites` (the launch counts the card checks expect) equals
    the kernel routes one `"fused"` forward takes, by stride: every ARCHS
    path of the narrow supernet, cream_14 (the released quirk's k3
    defaults in single-layer stages) and cream_481 at 64²."""
    taken, real = [], layers.dw_route

    def spy(mode, conv, stride, padding, groups, x):
        fn = real(mode, conv, stride, padding, groups, x)
        if fn is not None:
            taken.append(stride)
        return fn
    monkeypatch.setattr(layers, "dw_route", spy)
    layers.DW_REFUSED.clear()
    if case == "supernet":
        m = C.CreamSupernet(num_classes=10, stages=STAGES, img_size=IMG, device="cpu")
        runs = [(a, C.dw3x3_path_sites(a, STAGES)) for a in ARCHS]
    else:
        m = create_model(case, img_size=IMG, device="cpu")
        runs = [(None, C.dw3x3_path_sites(m.arch, m.stages, m.released_quirk))]
    set_dw_kernel(m.eval(), "fused")
    x = torch.from_numpy(_images(batch=1))
    for arch, want in runs:
        taken.clear()
        with torch.no_grad():
            m(x) if arch is None else m(x, config=arch)
        assert (taken.count(1), taken.count(2)) == want, (arch, want)
    assert not layers.DW_REFUSED and sum(sum(w) for _, w in runs) > len(runs)


# ---- registered models, goldens, the CLI ----

@pytest.mark.parametrize("name", sorted(C.RELEASED_CHILDNETS))
def test_param_count_equals_jax(name):
    """The released childnets' param counts equal JAX's (the supernet's
    layout is held weight for weight by the narrow tests, through
    `supernet_to_jax`); `cream_supernet`'s `config=` paths are JAX's draws."""
    assert name in list_models() and "cream_supernet" in list_models()
    m = create_model(name, device="meta")
    size = m.img_size
    assert size == C.RELEASED_CHILDNET_IMG_SIZE[name]
    assert create_model("cream_supernet", device="meta", config="seed:3").config == \
        [int(a) for a in nas.sample_architecture(np.random.default_rng(3), [4] * 5)]
    shapes = jax.eval_shape(lambda: jax_create_model(name).init(
        jax.random.key(0), jnp.zeros((1, size, size, 3))))
    n_jax = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes["params"]))
    assert sum(p.numel() for p in m.parameters()) == n_jax


def test_released_state_dict_round_trip_is_exact():
    """port -> JAX (`convert_for_model`, the reference's timm names) ->
    port, bit for bit; the flat path form of `cream_childnet`."""
    m = create_model("cream_43", device="cpu")
    sd = seeded_state_dict(m, 2)
    back = cream_state_dict_from_jax(convert_for_model("cream_43", _np_sd(sd)))
    assert set(back) == set(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    flat = create_model("cream_childnet", device="meta", arch=[3, -1, 4, 1, 2, -1, 0, 5])
    assert flat.arch == C.nest_arch([3, -1, 4, 1, 2, -1, 0, 5], C.SEARCH_STAGES) == \
        JC.nest_arch([3, -1, 4, 1, 2, -1, 0, 5])


def golden_input(size: int, seed: int = INPUT_SEED, batch: int = 2) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((batch, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("name", GOLDENS)
def test_full_width_matches_jax_golden(name):
    g = np.load(golden_path(name))
    assert int(g["input_seed"]) == INPUT_SEED and int(g["weight_seed"]) == WEIGHT_SEED
    m = create_model(name, device="cpu")
    m.load_state_dict(seeded_state_dict(m, WEIGHT_SEED))
    with torch.no_grad():
        got = m(torch.from_numpy(golden_input(m.img_size)))
    assert got.shape == (2, 1000)
    np.testing.assert_allclose(got.numpy(), g["logits"], atol=1e-5, rtol=1e-4)


def test_search_cream_cli_runs(tmp_path, capsys):
    """The campaign end to end: the board fills, the meta step runs, the
    best path's childnet matches the supernet (the CLI's own <= 1e-4 check)."""
    out = tmp_path / "cream.json"
    calls = []
    real = nas.make_meta_update_step

    def counting(*a, **k):
        step = real(*a, **k)
        return lambda *b: calls.append(1) or step(*b)
    search_cream.make_meta_update_step = counting
    try:
        result = search_cream.main(["--device", "cpu", "--flops-min", "4e6", "--flops-max",
                                    "12e6", "--epochs", "2", "--steps", "3",
                                    "--meta-sta-epoch", "0", "--lr", "0.01",
                                    "--batch-size", "8", "--num-classes", "8",
                                    "--img-size", "64", "--out", str(out)])
    finally:
        search_cream.make_meta_update_step = real
    saved = json.load(open(out))
    assert saved["best_arch"] == result["best_arch"] and len(saved["best_arch"]) == 6
    assert saved["history"][-1]["board"] >= 1 and calls
    assert saved["childnet_parity_maxdiff"] <= 1e-4
    assert "childnet parity maxdiff" in capsys.readouterr().out


# ---- the golden files ----

if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    DATA.mkdir(parents=True, exist_ok=True)
    for name in GOLDENS:
        port = create_model(name, device="cpu")
        variables = convert_for_model(name, _np_sd(seeded_state_dict(port, WEIGHT_SEED)))
        logits = jax.jit(jax_create_model(name).apply)(
            variables, jnp.asarray(golden_input(port.img_size)))
        np.savez(golden_path(name), logits=np.asarray(logits, np.float32),
                 input_seed=np.int64(INPUT_SEED), weight_seed=np.int64(WEIGHT_SEED))
        print(f"wrote {golden_path(name)}")
