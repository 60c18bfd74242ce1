"""cream_tpu_torch's iRPE (the host bucket tables of `ops/rpe.py` and the
`IRPE` module of `nn/rpe.py`) vs the JAX package's, in fp32 and bf16.

Inputs and tables come from numpy seeds; the tables are non-zero (a zero
table, iRPE's init, would hide a dropped or misindexed term). The JAX
module gets the port module's tables as its params.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cream_tpu.nn.rpe import IRPE as JaxIRPE
from cream_tpu.ops import rpe as jrpe
from cream_tpu_torch.nn.rpe import IRPE
from cream_tpu_torch.ops import rpe

METHODS = ("EUCLIDEAN", "QUANT", "PRODUCT", "CROSS_ROWS", "CROSS_COLS")


@pytest.mark.parametrize("ratio", [1.9, 20.0])
@pytest.mark.parametrize("grid", [7, 14])
@pytest.mark.parametrize("skip", [0, 1])
@pytest.mark.parametrize("method", METHODS)
def test_bucket_ids_equal_jax(method, skip, grid, ratio):
    """Every method (cross as its rows and cols tables) x skip x grid, bit
    for bit, with the bucket counts (the iRPE paper's ratio 1.9 and the
    JAX tests' 20)."""
    m = getattr(rpe.METHOD, method)
    assert m == getattr(jrpe.METHOD, method)
    args = (m, grid, grid, skip, 1 * ratio, 2 * ratio, 8 * ratio)
    ids, n = rpe.bucket_ids_2d(*args)
    want, n_want = jrpe.bucket_ids_2d(*args)
    assert n == n_want == rpe.num_buckets(m, 2 * ratio, skip) == \
        jrpe.num_buckets(m, 2 * ratio, skip)
    assert ids.dtype == want.dtype == np.int32 and ids.shape == (skip + grid ** 2,) * 2
    np.testing.assert_array_equal(ids, want)
    assert ids.min() >= 0 and ids.max() < n
    if skip:                       # the cls token's row and column: the extra bucket
        assert (ids[0] == n - 1).all() and (ids[:, 0] == n - 1).all()


def test_piecewise_index_rounds_half_to_even_as_jax():
    rel = np.concatenate([np.arange(-40, 41) / 2.0, np.random.default_rng(0).normal(0, 30, 500)])
    for a, b, g in ((1.9, 3.8, 15.2), (20.0, 40.0, 160.0), (3.0, 6.0, 24.0)):
        np.testing.assert_array_equal(rpe.piecewise_index(rel, a, b, g),
                                      jrpe.piecewise_index(rel, a, b, g))
        ints = np.arange(-50, 51)
        np.testing.assert_array_equal(rpe.piecewise_index(ints, a, b, g),
                                      jrpe.piecewise_index(ints, a, b, g))
    assert rpe.piecewise_index(np.array([0.5, 1.5, 2.5]), 3.0, 6.0, 24.0).tolist() == [0, 2, 2]


@pytest.mark.parametrize("rpe_on", ["k", "qk", "qkv"])
@pytest.mark.parametrize("method", ["product", "euc", "quant", "cross"])
def test_rpe_config_equals_jax(method, rpe_on):
    got = rpe.get_rpe_config(1.9, method, "ctx", True, 1, rpe_on)
    want = jrpe.get_rpe_config(1.9, method, "ctx", True, 1, rpe_on)
    for name in ("rpe_q", "rpe_k", "rpe_v"):
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None)
        if g is not None:
            assert dataclasses.asdict(g) == dataclasses.asdict(w)
            assert g.num_buckets == w.num_buckets


# ---- the module ----

H = W = 7
HEADS, D = 3, 8
# (mode, transposed, method, shared_head, skip)
CASES = [
    ("bias", True, "product", True, 0), ("bias", True, "product", False, 1),
    ("contextual", True, "product", True, 0), ("contextual", True, "product", True, 1),
    ("contextual", True, "product", False, 0), ("contextual", True, "product", False, 1),
    ("contextual", False, "product", True, 0), ("contextual", False, "product", True, 1),
    ("contextual", False, "product", False, 1), ("contextual", True, "cross", False, 1),
    ("contextual", False, "cross", True, 0), ("bias", True, "cross", True, 1),
    ("contextual", True, "euc", True, 1), ("contextual", True, "quant", False, 0),
]
CASE_IDS = ["-".join(str(v) for v in c) for c in CASES]


def _cfgs(mode, method, shared, skip):
    args = (1.9, method, mode, shared, skip, "k")
    return rpe.get_rpe_config(*args).rpe_k, jrpe.get_rpe_config(*args).rpe_k


def _pair(mode, transposed, method, shared, skip, dtype=torch.float32, seed=0):
    cfg, jcfg = _cfgs(mode, method, shared, skip)
    m = IRPE(D, HEADS, cfg, H, W, transposed=transposed, dtype=dtype, device="cpu")
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.from_numpy(rng.normal(0, 0.5, p.shape).astype(np.float32)))
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    return m, JaxIRPE(D, HEADS, jcfg, transposed=transposed, dtype=jdt)


def _params(m) -> dict:
    """The port module's tables as the JAX module's params (nested for the
    cross method's rp_rows / rp_cols)."""
    out: dict = {}
    for name, p in m.named_parameters():
        *path, leaf = name.split(".")
        node = out
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = jnp.asarray(p.detach().numpy().copy())
    return out


def _input(transposed, skip, batch=2, seed=1):
    L = skip + H * W
    shape = (batch, HEADS, L, D) if transposed else (batch, HEADS, L, L)
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_irpe_fp32_output_and_grads_match_jax(case):
    """Outputs, the tables' grads and the input's grad against `jax.grad`
    of sum(out · g), each within 1e-6 of its largest magnitude (fp32 sums
    in other orders: of 8 products or L = 49/50 one-hot terms forward, of up
    to B·L = 100 terms into a table's grad)."""
    mode, transposed, method, shared, skip = case
    m, jm = _pair(*case)
    x = _input(transposed, skip)
    out_shape = (2, HEADS, skip + H * W, D if not transposed else skip + H * W)
    g = np.random.default_rng(2).standard_normal(out_shape).astype(np.float32)

    def f(params, xj):
        y = jm.apply({"params": params}, xj, H, W)
        return jnp.sum(jnp.broadcast_to(y, out_shape) * g), y

    (_, want), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        _params(m), jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    y = m(xt)
    _close(torch.broadcast_to(y, out_shape).detach().numpy(),
           np.broadcast_to(np.asarray(want), out_shape), "out")
    (torch.broadcast_to(y, out_shape) * torch.from_numpy(g)).sum().backward()
    if mode == "bias":                     # the bias does not read x
        assert xt.grad is None and not np.asarray(gx).any()
    else:
        _close(xt.grad.numpy(), np.asarray(gx), "x grad")
    want_p = _params_like(gp)
    for name, p in m.named_parameters():
        _close(p.grad.numpy(), want_p[name], name)


def _close(got, want, what, rel=1e-6):
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (what, err, np.abs(want).max())


def _params_like(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_params_like(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


BF16_CASES = [("bias", True, "product", False, 1), ("contextual", True, "product", True, 1),
              ("contextual", True, "product", True, 0), ("bias", True, "cross", True, 1),
              ("contextual", True, "cross", True, 1)]


@pytest.mark.parametrize("case", BF16_CASES, ids=["-".join(map(str, c)) for c in BF16_CASES])
def test_irpe_bf16_within_two_ulps_of_jax(case):
    """bf16 compute, fp32 tables: the same rounding points (fp32 sums of
    the bf16 products cast to bf16; the cross method's two terms added in
    bf16). Within 2 bf16 ulps at the largest |out|. XLA's CPU runtime runs
    no batched bf16 x bf16 -> fp32 dot ("Unsupported element type for
    DotThunk"), so JAX's per-head contextual tables and its value route
    cannot run in bf16 here; their fp32 parity is above."""
    mode, transposed, method, shared, skip = case
    m, jm = _pair(*case, dtype=torch.bfloat16, seed=3)
    x = _input(transposed, skip, seed=4)
    x = np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    want = np.asarray(jm.apply({"params": _params(m)}, jnp.asarray(x).astype(jnp.bfloat16),
                               H, W), np.float32)
    with torch.no_grad():
        got = m(torch.from_numpy(x).bfloat16()).float().numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert np.abs(got - want).max() <= 2 * ulp, (np.abs(got - want).max(), ulp)


def test_irpe_is_bit_exact_across_two_runs_on_the_cpu():
    m, _ = _pair("contextual", True, "product", True, 1)
    x = torch.from_numpy(_input(True, 1)).requires_grad_()
    runs = []
    for _ in range(2):
        m.zero_grad()
        x.grad = None
        y = m(x)
        (y * y).sum().backward()
        runs.append((y.detach().clone(), x.grad.clone(), m.lookup_table_weight.grad.clone()))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_gather_index_is_broadcast_not_materialized():
    """The (L, L) bucket table reaches the gather through `expand`: nothing
    of (B, h, L, L) int64 is made or saved for the backward."""
    cfg, _ = _cfgs("contextual", "product", True, 1)
    m = IRPE(D, HEADS, cfg, H, W, device="cpu")
    B, L = 8, 1 + H * W
    x = torch.randn(B, HEADS, L, D, requires_grad=True)
    saved = []

    def pack(t):
        saved.append(t)
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y = m(x)
    ints = [t for t in saved if t.dtype == torch.int64]
    assert ints and all(t.untyped_storage().nbytes() == L * L * 8 for t in ints)
    assert y.shape == (B, HEADS, L, L)


def test_tables_are_parameters_and_buckets_are_buffers():
    cfg, _ = _cfgs("contextual", "product", True, 1)
    m = IRPE(64, 6, cfg, 14, 14, device="cpu")
    assert list(m.state_dict()) == ["lookup_table_weight"]
    assert m.lookup_table_weight.shape == (1, 64, 50) and not m.lookup_table_weight.any()
    assert m.bucket_ids.shape == (197, 197) and int(m.bucket_ids.max()) == 49
    v = IRPE(64, 6, cfg, 14, 14, transposed=False, device="cpu")
    assert v.lookup_table_weight.shape == (1, 50, 64) and v.onehot.shape == (197, 197, 50)
    cross = IRPE(8, 2, _cfgs("bias", "cross", False, 0)[0], 7, 7, device="cpu")
    assert sorted(cross.state_dict()) == ["rp_cols.lookup_table_bias",
                                          "rp_rows.lookup_table_bias"]
    # a distilled DeiT's two prefix tokens share the skip bucket
    two = IRPE(8, 2, cfg, 7, 7, skip=2, device="cpu")
    assert two.bucket_ids.shape == (51, 51) and two.lookup_table_weight.shape == (1, 8, 50)


def test_irpe_refuses_mismatched_inputs():
    cfg, _ = _cfgs("contextual", "product", True, 1)
    m = IRPE(D, HEADS, cfg, H, W, device="cpu")
    with pytest.raises(ValueError, match="50 tokens"):
        m(torch.zeros(1, HEADS, 49, D))
    with pytest.raises(ValueError, match="transposed-only"):
        IRPE(D, HEADS, _cfgs("bias", "product", True, 1)[0], H, W, transposed=False)
