"""cream_tpu_torch's DeiT with iRPE, Mini-DeiT and Mini-Swin's distillation
capture vs the JAX package's, on shared seeded weights, in eval and in train
steps.

Weights: `seeded_state_dict` on the port's model (iRPE tables N(0, 0.05²):
a zero table would hide a dropped or misindexed term), carried to the JAX
model by `cream_tpu.zoo.import_torch.convert_deit_rpe` / `convert_mini_deit`
/ `convert_mini_swin`; the port's `*_state_dict_from_jax` carry them back.
Inputs: numpy seeds. No TPU kernel lies on these paths.

Regenerate the golden files (JAX fp32 B=2 logits of
deit_small_patch16_224_ctx_product_50_shared_k,
deit_tiny_patch16_224_ctx_product_50_shared_qkv and
mini_deit_small_patch16_224, and one fp32 JAX train step of the first) with
    PYTHONPATH=.:tests python tests/test_torch_deit_rpe.py
"""
from pathlib import Path

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from cream_tpu.models import create_model as jax_create_model
from cream_tpu.models.deit_rpe import RPEVisionTransformer as JaxDeiT
from cream_tpu.models.mini_deit import MiniDeiT as JaxMiniDeiT
from cream_tpu.models.swin import MiniSwin as JaxMiniSwin
from cream_tpu.ops.rpe import get_rpe_config as jax_rpe_config
from cream_tpu.train import TrainState as JaxTrainState
from cream_tpu.train import losses as jax_losses
from cream_tpu.train import make_train_step as jax_make_train_step
from cream_tpu.train import optim as jax_optim
from cream_tpu.zoo.import_torch import convert_deit_rpe, convert_mini_deit, convert_mini_swin
from cream_tpu.zoo.load import convert_for_model
from cream_tpu_torch.cli import inference, train
from cream_tpu_torch.cli.inference import predict
from cream_tpu_torch.models import create_model, list_models
from cream_tpu_torch.models.deit_rpe import RPEVisionTransformer
from cream_tpu_torch.models.mini_deit import MiniDeiT
from cream_tpu_torch.models.registry import accepts
from cream_tpu_torch.models.swin import MiniSwin
from cream_tpu_torch.ops.rpe import get_rpe_config
from cream_tpu_torch.train import losses, optim
from cream_tpu_torch.train.state import TrainState
from cream_tpu_torch.train.steps import loss_and_grads, make_train_step
from cream_tpu_torch.zoo.load import (deit_rpe_state_dict_from_jax, load_pth,
                                      mini_deit_state_dict_from_jax,
                                      mini_swin_state_dict_from_jax, seeded_state_dict)

from test_torch_train import _leaves
from torch_threads import one_torch_thread_module  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
DATA = REPO / "tests" / "data" / "torch_port"
WEIGHT_SEED, INPUT_SEED = 0, 1
DEIT_S_K = "deit_small_patch16_224_ctx_product_50_shared_k"
FULL = (DEIT_S_K, "deit_tiny_patch16_224_ctx_product_50_shared_qkv",
        "mini_deit_small_patch16_224")
TRAIN_GOLDEN = DATA / "deit_small_rpe_k_train_seed0.npz"
NAMES = [f"deit_{s}_patch16_224{t}" for s in ("tiny", "small", "base")
         for t in ("", "_ctx_product_50_shared_k", "_ctx_product_50_shared_qk",
                   "_ctx_product_50_shared_qkv")] + \
    [f"mini_deit_{s}_patch16_224" for s in ("tiny", "small", "base")]


def golden_path(name: str) -> Path:
    return DATA / f"{name}_seed0.npz"


def _np(t):
    """A numpy copy (a view would follow the port's in-place updates)."""
    return t.detach().cpu().numpy().copy()


def _np_sd(sd):
    return {k: _np(v) for k, v in sd.items()}


# ---- narrow models: dim 64, 2 heads, 32² images with patch 8 (a 4x4 grid) ----

NARROW = dict(num_classes=10, img_size=32, patch_size=8, embed_dim=64, num_heads=2)


def _deit(rpe_on, distilled=False, dtype=torch.float32, depth=2):
    cfg = None if rpe_on is None else get_rpe_config(1.9, "product", "ctx", True, 1, rpe_on)
    jcfg = None if rpe_on is None else jax_rpe_config(1.9, "product", "ctx", True, 1, rpe_on)
    m = RPEVisionTransformer(**NARROW, depth=depth, distilled=distilled, rpe_config=cfg,
                             dtype=dtype, device="cpu")
    m.load_state_dict(seeded_state_dict(m, 5))
    jkw = {k: v for k, v in NARROW.items() if k != "img_size"}
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    jm = JaxDeiT(**jkw, depth=depth, distilled=distilled, rpe_config=jcfg, dtype=jdt)
    return m.eval(), jm, lambda sd: convert_deit_rpe(_np_sd(sd), depth=depth)


def _mini(dtype=torch.float32, depth=4):
    m = MiniDeiT(**NARROW, depth=depth, dtype=dtype, device="cpu")
    m.load_state_dict(seeded_state_dict(m, 5))
    jkw = {k: v for k, v in NARROW.items() if k != "img_size"}
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    jm = JaxMiniDeiT(**jkw, depth=depth, dtype=jdt)
    return m.eval(), jm, lambda sd: convert_mini_deit(_np_sd(sd), depth=depth)


def _images(seed=7, batch=2, size=32):
    return np.random.default_rng(seed).standard_normal((batch, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("rpe_on,distilled", [(None, False), ("k", False), ("qk", True),
                                               ("qkv", False), ("qkv", True)])
def test_narrow_deit_matches_jax(rpe_on, distilled):
    """Eval logits within 1e-5 of JAX's (fp32 sums in other orders); a
    distilled model's train-mode pair too (drop path 0: no draws). The
    distilled model's two prefix tokens share the iRPE skip bucket."""
    m, jm, to_jax = _deit(rpe_on, distilled)
    x = _images()
    variables = to_jax(m.state_dict())
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    got = predict(m, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    if distilled:
        jpair = jax.jit(lambda v, x: jm.apply(v, x, train=True))(variables, jnp.asarray(x))
        m.train()
        with torch.no_grad():
            pair = m(torch.from_numpy(x))
        assert isinstance(pair, tuple) and len(pair) == 2
        for a, b in zip(pair, jpair):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(got, (pair[0].numpy() + pair[1].numpy()) / 2, atol=1e-6)


def test_narrow_mini_deit_matches_jax():
    m, jm, to_jax = _mini()
    x = _images()
    want = np.asarray(jax.jit(jm.apply)(to_jax(m.state_dict()), jnp.asarray(x)))
    np.testing.assert_allclose(predict(m, torch.from_numpy(x)).numpy(), want,
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kind", ["deit_k", "deit_qk", "mini"])
def test_narrow_bf16_within_four_ulps_of_jax(kind):
    """bf16 compute with fp32 params: the same rounding points (q scaled in
    bf16, fp32 scores plus the bf16 iRPE term, softmax in fp32 or, behind
    Mini-DeiT's head transforms, on bf16 scores). F.linear adds the bias
    inside the GEMM where flax adds it to the rounded product; within 4 bf16
    ulps at the largest |logit|. (XLA's CPU runtime has no batched bf16 x
    bf16 -> fp32 dot, which JAX's value route needs: `qkv` is held in fp32
    here and on the card.)"""
    m, jm, to_jax = _mini(torch.bfloat16) if kind == "mini" else \
        _deit(kind.split("_")[1], dtype=torch.bfloat16)
    x = np.array(jnp.asarray(_images(8)).astype(jnp.bfloat16).astype(jnp.float32))
    want = np.asarray(jax.jit(jm.apply)(to_jax(m.state_dict()), jnp.asarray(x)), np.float32)
    got = predict(m, torch.from_numpy(x)).numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert np.abs(got - want).max() <= 4 * ulp, (np.abs(got - want).max(), ulp)


def test_rpe_tables_are_seen():
    """Zeroing the seeded iRPE tables moves the logits far beyond the parity
    tolerance, so the tests above would see a dropped or misindexed term."""
    m, _, _ = _deit("qkv")
    x = torch.from_numpy(_images())
    base = predict(m, x)
    for name, p in m.named_parameters():
        if "lookup_table" in name:
            assert p.abs().max() > 0.05
            p.data.zero_()
    assert (predict(m, x) - base).abs().max() > 1e-2


# ---- training ----

LR = dict(base_lr=1e-3, warmup_steps=1, total_steps=5, warmup_init_lr=1e-4, min_lr=1e-5)


def _batch(seed, batch=4, num_classes=10):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, 32, 32, 3)).astype(np.float32)
    return x, np.eye(num_classes, dtype=np.float32)[rng.integers(0, num_classes, batch)]


@pytest.mark.parametrize("kind", ["deit_qkv", "mini"])
def test_narrow_three_train_steps_match_jax(kind):
    """3 AdamW steps (warmup + cosine, clipping, EMA, drop path 0) against
    JAX's `make_train_step`: loss, grad_norm and every weight within 1e-5,
    but for two kinds of element whose grad is 0 up to float noise, which
    Adam's sign-like first update moves by up to lr either way on either
    side, so they are held to 2·Σlr: the k-projection's qkv bias (a
    constant per query row under the softmax), and DeiT's last `rpe_k`
    table (only the cls row reaches the head, and its keys all share the
    skip bucket: a constant along that row too)."""
    m, jm, to_jax = _mini() if kind == "mini" else _deit("qkv")
    params = to_jax(m.state_dict())["params"]
    jtx = jax_optim.make_adamw(jax_optim.cosine_schedule(*LR.values()), weight_decay=0.05,
                               clip_grad=5.0, params=params)
    jstate = JaxTrainState.create(params=params, tx=jtx, ema_decay=0.9)
    jstep = jax_make_train_step(jm, loss_fn=jax_losses.soft_target_ce, donate=False)
    tx = optim.make_adamw(optim.cosine_schedule(*LR.values()), weight_decay=0.05,
                          clip_grad=5.0, params=dict(m.named_parameters()))
    state = TrainState(m, tx, ema_decay=0.9)
    step = make_train_step(loss_fn=losses.soft_target_ce)
    lrs = []
    for i in range(3):
        x, y = _batch(10 + i)
        lrs.append(state.tx.lr())
        state, metrics = step(state, {"image": torch.from_numpy(x), "label": torch.from_numpy(y)})
        jstate, jmetrics = jstep(jstate, {"image": jnp.asarray(x), "label": jnp.asarray(y)},
                                 jax.random.key(0))
        np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(metrics["grad_norm"]), float(jmetrics["grad_norm"]),
                                   rtol=1e-5)
    dim, noise = NARROW["embed_dim"], 2 * sum(lrs)
    for got_tree, want_tree in ((state.params, jstate.params),
                                (state.ema_params, jstate.ema_params)):
        got = _leaves(to_jax(got_tree)["params"])
        for k, w in _leaves(want_tree).items():
            err = np.abs(got[k] - w)
            if k.endswith("qkv/bias"):
                assert err[dim:2 * dim].max() <= noise, k
                err = np.concatenate([err[:dim], err[2 * dim:]])
            if k == "blocks_1/attn/rpe_k/lookup_table_weight":
                assert err.max() <= noise, k
                continue
            assert err.max() <= 1e-5, (k, err.max())
    assert state.step == int(jstate.step) == 3


def test_train_step_refuses_a_distilled_pair():
    m, _, _ = _deit("k", distilled=True)
    x, y = _batch(1)
    with pytest.raises(TypeError, match="tuple in train mode"):
        loss_and_grads(m, {"image": torch.from_numpy(x), "label": torch.from_numpy(y)},
                       losses.soft_target_ce)


def test_drop_path_rates_and_draws():
    """DeiT: one rate a block, 0 .. drop_path_rate; Mini-DeiT: one rate a
    repeat over the executed layers, drawn for the attention and the MLP
    branch of each repeat from the generator given to forward."""
    m = create_model(DEIT_S_K, device="cpu", drop_path_rate=0.1)
    np.testing.assert_allclose([b.drop_path_rate for b in m.blocks],
                               [0.1 * i / 11 for i in range(12)])
    mini = create_model("mini_deit_small_patch16_224", device="cpu", drop_path_rate=0.1)
    rates = [r for b in mini.blocks for r in b["block"].drop_path_rates]
    np.testing.assert_allclose(rates, [0.1 * i / 11 for i in range(12)])
    assert len(mini.blocks) == 6
    small, _, _ = _mini()
    for b in small.blocks:
        b["block"].drop_path_rates = (0.5, 0.5)
    small.train()
    x = torch.from_numpy(_images(batch=8))
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        a = small(x, torch.Generator().manual_seed(3))
        b = small(x, torch.Generator().manual_seed(3))
        c = small(x, gen)
    assert torch.equal(a, b) and not torch.equal(a, c)
    # 2 physical blocks x 2 repeats x (attention, MLP): 8 draws of (8, 1, 1)
    assert torch.equal(gen.get_state(),
                       _advanced(torch.Generator().manual_seed(0), 8, (8, 1, 1)).get_state())
    with pytest.raises(ValueError, match="generator"):
        small(x)


def _advanced(gen, n, shape):
    for _ in range(n):
        torch.rand(shape, generator=gen)
    return gen


# ---- full width ----

def golden_input(seed: int = INPUT_SEED, batch: int = 2) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((batch, 224, 224, 3)).astype(np.float32)


def _golden_batch():
    rng = np.random.default_rng(INPUT_SEED)
    x = rng.standard_normal((2, 224, 224, 3)).astype(np.float32)
    return x, np.eye(1000, dtype=np.float32)[rng.integers(0, 1000, 2)]


@pytest.mark.parametrize("name", FULL)
def test_full_width_matches_jax_golden(name):
    g = np.load(golden_path(name))
    assert int(g["input_seed"]) == INPUT_SEED and int(g["weight_seed"]) == WEIGHT_SEED
    m = create_model(name, device="cpu")
    m.load_state_dict(seeded_state_dict(m, WEIGHT_SEED))
    got = predict(m, torch.from_numpy(golden_input()))
    assert got.shape == (2, 1000) and got.dtype == torch.float32
    # fp32 through 12 blocks with sums in other orders
    np.testing.assert_allclose(got.numpy(), g["logits"], atol=1e-4, rtol=1e-4)


def test_full_width_deit_s_rpe_k_train_step_matches_jax_golden():
    """One fp32 B=2 step (drop path 0): loss 1e-5, global grad norm 1e-4,
    per-tensor grad norms 1e-3, and the 12 iRPE tables' grads within 1e-4 of
    their largest magnitude."""
    g = np.load(TRAIN_GOLDEN)
    m = create_model(DEIT_S_K, device="cpu")
    m.load_state_dict(seeded_state_dict(m, WEIGHT_SEED))
    x, y = _golden_batch()
    loss, _, grads = loss_and_grads(m, {"image": torch.from_numpy(x),
                                        "label": torch.from_numpy(y)}, losses.soft_target_ce)
    assert sorted(grads) == list(g["names"])
    np.testing.assert_allclose(float(loss), float(g["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(optim.global_norm(grads.values())),
                               float(g["grad_norm"]), rtol=1e-4)
    got = np.asarray([float(grads[n].norm()) for n in g["names"]])
    np.testing.assert_allclose(got, g["grad_norms"], rtol=1e-3,
                               atol=1e-7 * float(g["grad_norm"]))
    tables = np.stack([_np(grads[f"blocks.{i}.attn.rpe_k.lookup_table_weight"])
                       for i in range(12)])
    want = g["table_grads"]
    assert tables.shape == want.shape == (12, 1, 64, 50)
    assert np.abs(tables - want).max() <= 1e-4 * np.abs(want).max()


def _jax_variables(name: str, sd) -> dict:
    return convert_for_model(name, _np_sd(sd))


@pytest.mark.parametrize("name", NAMES)
def test_param_count_equals_jax(name):
    assert name in list_models() and accepts(name, "drop_path_rate")
    m = create_model(name, device="meta")
    shapes = jax.eval_shape(lambda: jax_create_model(name).init(
        jax.random.key(0), jnp.zeros((1, 224, 224, 3))))
    n_jax = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes["params"]))
    assert sum(p.numel() for p in m.parameters()) == n_jax
    if name == DEIT_S_K:      # iRPE/README.md: 22.09M
        assert n_jax == 22_089_064


@pytest.mark.parametrize("name,distilled", [
    ("deit_tiny_patch16_224", False), (FULL[0], False), (FULL[1], True),
    ("mini_deit_tiny_patch16_224", False)])
def test_state_dict_round_trip_is_exact(name, distilled):
    """port -> JAX (`convert_for_model`, the reference's names) -> port."""
    kw = {"distilled": True} if distilled else {}
    m = create_model(name, device="cpu", **kw)
    sd = seeded_state_dict(m, 3)
    inverse = mini_deit_state_dict_from_jax if name.startswith("mini") \
        else deit_rpe_state_dict_from_jax
    back = inverse(_jax_variables(name, sd))
    assert set(back) == set(sd)
    for k in sd:
        assert back[k].dtype == sd[k].dtype and torch.equal(back[k], sd[k]), k
    m.load_state_dict(back, strict=True)


def test_released_pth_loads_and_the_inference_cli_runs(tmp_path, capsys):
    """A DeiT checkpoint is {"model": state_dict}: `load_pth` unwraps it and
    the inference CLI predicts with it."""
    from PIL import Image
    name = "deit_tiny_patch16_224_ctx_product_50_shared_k"
    m = create_model(name, device="cpu")
    sd = seeded_state_dict(m, 4)
    torch.save({"model": sd}, tmp_path / "deit.pth")
    got = load_pth(str(tmp_path / "deit.pth"))
    assert set(got) == set(sd) and all(torch.equal(got[k], sd[k]) for k in sd)
    rng = np.random.default_rng(0)
    Image.fromarray(rng.integers(0, 255, (240, 320, 3), dtype=np.uint8)).save(tmp_path / "i.png")
    top5 = inference.main(["--image", str(tmp_path / "i.png"), "--torch-ckpt",
                           str(tmp_path / "deit.pth"), "--device", "cpu",
                           f"model.name={name}", "model.dtype=float32"])
    assert len(top5) == 5 and capsys.readouterr().out.count("top") == 5


@pytest.mark.parametrize("name", ["deit_tiny_patch16_224_ctx_product_50_shared_qkv",
                                  "mini_deit_tiny_patch16_224"])
def test_train_cli_runs(tmp_path, capsys, name):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    base = ["--device", "cpu", f"model.name={name}", "model.dtype=float32",
            "model.img_size=32", "data.img_size=32", "data.dataset=synthetic",
            "data.batch_size=16", "data.num_workers=2", "train.epochs=1",
            "train.warmup_epochs=0", "model.drop_path_rate=0.1", f"output={tmp_path}"]
    try:
        train.main(base)
        out = capsys.readouterr().out
        assert "epoch 0 [0/4]" in out and "epoch 0 done" in out
        if name.startswith("deit"):
            with pytest.raises(TypeError, match="tuple in train mode"):
                train.main(base + ['model.extra={"distilled": true}', "tag=distilled"])
    finally:
        torch.set_num_threads(n)


# ---- Mini-Swin: MiniViT's switches and distillation capture ----

MINI_SWIN = dict(embed_dims=(32, 64, 64, 128), depths=(2, 2, 2, 2), num_heads=(1, 2, 2, 4),
                 num_classes=10)
SWITCHES = ("is_sep_layernorm", "is_transform_heads", "is_transform_ffn")


def _mini_swin_variables(sd, share, **switches) -> dict:
    """The port's Mini-Swin state_dict as JAX variables with the switches
    off: `convert_mini_swin` reads the per-repeat names, so they are filled
    in before it runs and the JAX layout's own names restored after."""
    sd = _np_sd(sd)
    blocks = {k.rsplit(".", 3)[0] for k in sd if ".blocks." in k and k.endswith("attn.qkv.weight")}
    for b in blocks:
        heads = MINI_SWIN["num_heads"][int(b.split(".")[1])]
        for r in range(share):
            if not switches.get("is_sep_layernorm", True):
                for n in (1, 2):
                    for p in ("weight", "bias"):
                        sd[f"{b}.norm{n}_list.{r}.{p}"] = sd[f"{b}.norm{n}.{p}"]
            if not switches.get("is_transform_heads", True):
                for t in ("proj_l", "proj_w"):
                    sd[f"{b}.{t}.{r}.weight"] = np.zeros((heads, heads), np.float32)
                    sd[f"{b}.{t}.{r}.bias"] = np.zeros(heads, np.float32)
    variables = convert_mini_swin(sd, depths=MINI_SWIN["depths"], share_num=share)
    for key, block in variables["params"].items():
        if "_block_" not in key:
            continue
        for r in range(share):
            if not switches.get("is_sep_layernorm", True):
                block["norm1"], block["norm2"] = block.pop(f"norm1_list_{r}"), \
                    block.pop(f"norm2_list_{r}")
            if not switches.get("is_transform_heads", True):
                del block[f"proj_l_{r}"], block[f"proj_w_{r}"]
    return variables


def test_mini_swin_capture_matches_jax_intermediates():
    """capture_distill: every executed layer's qkv states (3, B·windows,
    heads, N, d) and hidden states (B, H·W, C) in the order JAX sows them
    (`mutable=["intermediates"]`), within 1e-5 of their largest magnitude;
    the logits with capture bit for bit those without."""
    m = MiniSwin(img_size=64, share_num=2, device="cpu", capture_distill=True, **MINI_SWIN)
    m.load_state_dict(seeded_state_dict(m, 5))
    m.eval()
    x = _images(7, size=64)
    jm = JaxMiniSwin(share_num=2, capture_distill=True, **MINI_SWIN)
    want, state = jax.jit(lambda v, x: jm.apply(v, x, mutable=["intermediates"]))(
        convert_mini_swin(_np_sd(m.state_dict()), depths=MINI_SWIN["depths"], share_num=2),
        jnp.asarray(x))
    with torch.no_grad():
        logits, captures = m(torch.from_numpy(x))
        m.capture_distill = False
        plain = m(torch.from_numpy(x))
    assert torch.equal(logits, plain)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    blocks = list(state["intermediates"].values())
    want_qkv = [np.asarray(t) for b in blocks for t in b["attn"]["qkv_states"]]
    want_hidden = [np.asarray(t) for b in blocks for t in b["hidden"]]
    assert len(captures["qkv_states"]) == len(want_qkv) == 8 == len(captures["hidden"])
    for got, w in zip(captures["qkv_states"] + captures["hidden"], want_qkv + want_hidden):
        assert tuple(got.shape) == w.shape
        assert np.abs(got.numpy() - w).max() <= 1e-5 * np.abs(w).max()
    assert captures["qkv_states"][0].shape == (3, 2 * 9, 1, 49, 32)    # 16x16 map -> 21x21 padded


@pytest.mark.parametrize("switch", SWITCHES)
def test_mini_swin_switch_off_matches_jax(switch):
    """Each of MiniViT's switches off in turn: the names the JAX layout
    implies, logits within 1e-5 of JAX's, and the variables' exact way back.
    JAX's `is_sep_layernorm=False` makes its shared `norm1` once a repeat,
    which flax refuses from the second repeat on (a JAX-side fault): there
    JAX runs at one repeat a block, and at two the port's shared norms are
    held bit for bit to per-repeat copies of them."""
    share = 1 if switch == "is_sep_layernorm" else 2
    m = MiniSwin(img_size=64, share_num=share, device="cpu", **{switch: False}, **MINI_SWIN)
    sd = seeded_state_dict(m, 5)
    m.load_state_dict(sd)
    names = list(sd)
    gone = {"is_sep_layernorm": ".norm1_list.", "is_transform_heads": ".proj_l.",
            "is_transform_ffn": ".local_conv_list."}[switch]
    assert not any(gone in k for k in names)
    variables = _mini_swin_variables(sd, share, **{switch: False})
    want = jax.jit(JaxMiniSwin(share_num=share, **{switch: False}, **MINI_SWIN).apply)(
        variables, jnp.asarray(_images(7, size=64)))
    got = predict(m.eval(), torch.from_numpy(_images(7, size=64)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    back = mini_swin_state_dict_from_jax(variables)
    assert set(back) == set(sd) and all(torch.equal(back[k], sd[k]) for k in sd)
    if switch == "is_sep_layernorm":
        with pytest.raises(Exception, match="norm1"):
            jax.eval_shape(lambda: JaxMiniSwin(share_num=2, is_sep_layernorm=False,
                                               **MINI_SWIN).init(
                jax.random.key(0), jnp.zeros((1, 64, 64, 3))))
        shared = MiniSwin(img_size=64, device="cpu", is_sep_layernorm=False, **MINI_SWIN)
        sep = MiniSwin(img_size=64, device="cpu", **MINI_SWIN)
        sd = seeded_state_dict(shared, 5)
        shared.load_state_dict(sd)
        copies = {}
        for k, v in sd.items():
            for n in (".norm1.", ".norm2."):
                if n in k:
                    for r in range(2):
                        copies[k.replace(n, f"{n[:-1]}_list.{r}.")] = v
        sep.load_state_dict({**{k: v for k, v in sd.items() if k not in
                                {k for k in sd if ".norm1." in k or ".norm2." in k}},
                             **copies})
        x = torch.from_numpy(_images(7, size=64))
        assert torch.equal(predict(shared.eval(), x), predict(sep.eval(), x))


def test_mini_swin_registry_takes_the_capture():
    m = create_model("mini_swin_tiny", device="cpu", capture_distill=True, img_size=64)
    assert m.capture_distill and all(b.is_transform_heads and b.is_sep_layernorm
                                     and b.is_transform_ffn
                                     for layer in m.layers for b in layer.blocks)
    with pytest.raises(TypeError):
        create_model("swin_tiny", device="cpu", capture_distill=True)


# ---- the golden files ----

def jax_logits(name: str) -> np.ndarray:
    port = create_model(name, device="cpu")
    variables = _jax_variables(name, seeded_state_dict(port, WEIGHT_SEED))
    return np.asarray(jax.jit(jax_create_model(name).apply)(variables, jnp.asarray(golden_input())))


def _name_bridge(model, name) -> dict[str, str]:
    """JAX param path -> port param name (a unique value per param carried
    through the converter)."""
    names = list(dict(model.named_parameters()))
    ids = {k: torch.full_like(p, float(i)) for i, (k, p) in enumerate(model.named_parameters())}
    bridge = {path: names[int(v.flat[0])]
              for path, v in _leaves(_jax_variables(name, ids)["params"]).items()}
    assert sorted(bridge.values()) == sorted(names)
    return bridge


def jax_deit_s_train_golden() -> dict:
    """One fp32 JAX train step of DeiT-S iRPE-K (drop path 0) on the seeded
    weights: loss, grad_norm, per-param grad norms by port name, and the 12
    rpe_k tables' grads."""
    port = create_model(DEIT_S_K, device="cpu")
    params = _jax_variables(DEIT_S_K, seeded_state_dict(port, WEIGHT_SEED))["params"]
    jm = jax_create_model(DEIT_S_K)
    x, y = _golden_batch()

    def f(p):
        return jax_losses.soft_target_ce(jm.apply({"params": p}, x, train=True), y)
    loss, grads = jax.jit(jax.value_and_grad(f))(params)
    bridge = _name_bridge(port, DEIT_S_K)
    flat = {bridge[p]: g for p, g in _leaves(grads).items()}
    names = sorted(flat)
    return {"loss": np.float32(loss), "grad_norm": np.float32(optax.global_norm(grads)),
            "names": np.asarray(names),
            "grad_norms": np.asarray([np.linalg.norm(flat[n]) for n in names], np.float32),
            "table_grads": np.stack([flat[f"blocks.{i}.attn.rpe_k.lookup_table_weight"]
                                     for i in range(12)]).astype(np.float32),
            "input_seed": np.int64(INPUT_SEED), "weight_seed": np.int64(WEIGHT_SEED)}


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    DATA.mkdir(parents=True, exist_ok=True)
    for name in FULL:
        np.savez(golden_path(name), logits=jax_logits(name).astype(np.float32),
                 input_seed=np.int64(INPUT_SEED), weight_seed=np.int64(WEIGHT_SEED))
        print(f"wrote {golden_path(name)}")
    np.savez_compressed(TRAIN_GOLDEN, **jax_deit_s_train_golden())
    print(f"wrote {TRAIN_GOLDEN}")
