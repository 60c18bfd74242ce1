"""cream_tpu_torch's Swin lineage (Swin, S3, Mini-Swin) vs the JAX package's,
on shared seeded weights, in eval and in a train step.

Weights: `seeded_state_dict` on the port's model, carried to the JAX model by
`cream_tpu.zoo.import_torch.convert_swin` / `convert_mini_swin`. Inputs:
numpy seeds. On the CPU the JAX modules take their plain route (the Pallas
kernel path is TPU-only), and the port's attention runs K1's plain version
`window_attention_ref`, or, with Mini-Swin's head transforms, the JAX plain
route's mirror.

Regenerate the golden files (JAX fp32 logits of s3_tiny, swin_tiny and
mini_swin_tiny, and one fp32 JAX train step of s3_tiny) with
    PYTHONPATH=.:tests python tests/test_torch_swin.py
"""
import functools
from pathlib import Path

import flax.linen as fnn
import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from cream_tpu.models import create_model as jax_create_model
from cream_tpu.models.swin import MiniSwin as JaxMiniSwin
from cream_tpu.models.swin import SwinTransformer as JaxSwin
from cream_tpu.nn import swin as jswin
from cream_tpu.train import TrainState as JaxTrainState
from cream_tpu.train import losses as jax_losses
from cream_tpu.train import make_train_step as jax_make_train_step
from cream_tpu.train import optim as jax_optim
from cream_tpu.zoo.import_torch import convert_mini_swin, convert_swin
from cream_tpu_torch.cli.inference import predict
from cream_tpu_torch.cli.profile_step import use_plain_attention
from cream_tpu_torch.models import create_model, list_models
from cream_tpu_torch.models.swin import MiniSwin, SwinTransformer
from cream_tpu_torch.nn import swin
from cream_tpu_torch.train import losses, optim
from cream_tpu_torch.train.state import TrainState
from cream_tpu_torch.train.steps import loss_and_grads, make_train_step
from cream_tpu_torch.zoo.load import (load_pth, mini_swin_state_dict_from_jax,
                                      seeded_state_dict, swin_state_dict_from_jax)

from test_torch_train import _leaves
from torch_threads import one_torch_thread_module  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
DATA = REPO / "tests" / "data" / "torch_port"
WEIGHT_SEED, INPUT_SEED = 0, 1
FULL = ("s3_tiny", "swin_tiny", "mini_swin_tiny")
TRAIN_GOLDEN = DATA / "s3_tiny_train_seed0.npz"
# (depths, share_num) of each registered variant, for the JAX converters
DEPTHS = {"swin_tiny": (2, 2, 6, 2), "swin_small": (2, 2, 18, 2), "swin_base": (2, 2, 18, 2),
          "s3_tiny": (2, 2, 6, 2), "s3_small": (2, 2, 18, 2), "s3_base": (2, 2, 30, 2),
          "mini_swin_tiny": (2, 2, 6, 2), "mini_swin_small": (2, 2, 18, 2),
          "mini_swin_base": (2, 2, 18, 2)}
SHARE = {"mini_swin_tiny": 6, "mini_swin_small": 2, "mini_swin_base": 2}


def golden_path(name: str) -> Path:
    return DATA / f"{name}_seed0.npz"


def _np(t):
    """A numpy copy (a view would follow the port's in-place updates)."""
    return t.detach().cpu().numpy().copy()


def _np_sd(sd):
    return {k: _np(v) for k, v in sd.items()}


def _to_jax(sd, depths, share=None):
    if share is not None:
        return convert_mini_swin(_np_sd(sd), depths=depths, share_num=share)
    return convert_swin(_np_sd(sd), depths=depths)


def golden_input(seed: int = INPUT_SEED, batch: int = 2) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (batch, 224, 224, 3)).astype(np.float32)


def jax_logits(name: str) -> np.ndarray:
    """The JAX package's fp32 logits of `name` on the seeded weights."""
    port = create_model(name, device="cpu")
    variables = _to_jax(seeded_state_dict(port, WEIGHT_SEED), DEPTHS[name], SHARE.get(name))
    jm = jax_create_model(name)
    return np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(golden_input())))


@pytest.fixture(scope="module", params=FULL)
def full_width(request):
    return request.param, jax_logits(request.param)


# ---- primitives ----

@pytest.mark.parametrize("wh,ww", [(7, 7), (14, 14), (4, 6), (13, 13)])
def test_relative_position_index_equals_jax(wh, ww):
    got = swin.relative_position_index(wh, ww)
    np.testing.assert_array_equal(got, jswin.relative_position_index(wh, ww))
    assert got.max() == (2 * wh - 1) * (2 * ww - 1) - 1


@pytest.mark.parametrize("H,W,window,shift", [(56, 56, 7, 3), (28, 28, 7, 3),
                                              (14, 14, 7, 3), (14, 21, 7, 3),
                                              (12, 12, 4, 2)])
def test_shifted_window_mask_equals_jax(H, W, window, shift):
    got = swin.shifted_window_mask(H, W, window, shift)
    np.testing.assert_array_equal(got, jswin.shifted_window_mask(H, W, window, shift))
    t = swin.shifted_window_mask_tensor(H, W, window, shift, torch.device("cpu"))
    assert t is swin.shifted_window_mask_tensor(H, W, window, shift, torch.device("cpu"))
    np.testing.assert_array_equal(t.numpy(), got)


def test_mask_made_under_inference_mode_can_be_saved_for_backward():
    with torch.inference_mode():
        m = swin.shifted_window_mask_tensor(21, 21, 7, 3, torch.device("cpu"))
    assert not m.is_inference()


def _attn_variables(attn: swin.SwinWindowAttention, transforms=None) -> dict:
    """The port module's weights as the JAX SwinWindowAttention's params."""
    sd = _np_sd(attn.state_dict())
    p = {"qkv": {"kernel": sd["qkv.weight"].T, "bias": sd["qkv.bias"]},
         "proj": {"kernel": sd["proj.weight"].T, "bias": sd["proj.bias"]},
         "relative_position_bias_table": sd["relative_position_bias_table"]}
    if transforms is None:
        return {"params": p}
    out = {"attn": p}
    for name, fc in zip(("proj_l", "proj_w"), transforms):
        out[name] = {"kernel": _np(fc.weight).T, "bias": _np(fc.bias)}
    return {"params": out}


class _JaxAttnWithTransforms(fnn.Module):
    """The JAX attention with MiniViT's head transforms, as MiniSwinBlock
    builds them."""
    dim: int
    window: int
    heads: int
    dtype: object = jnp.float32

    @fnn.compact
    def __call__(self, x, mask):
        attn = jswin.SwinWindowAttention(self.dim, self.window, self.heads,
                                         dtype=self.dtype, name="attn")
        return attn(x, mask=mask,
                    proj_l=fnn.Dense(self.heads, dtype=self.dtype, name="proj_l"),
                    proj_w=fnn.Dense(self.heads, dtype=self.dtype, name="proj_w"))


def _attn_pair(dim, window, heads, dtype, seed, transforms):
    torch_dtype = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}[dtype]
    attn = swin.SwinWindowAttention(dim, window, heads, dtype=torch_dtype, device="cpu")
    attn.load_state_dict(seeded_state_dict(attn, seed))
    fcs = None
    if transforms:
        fcs = [torch.nn.Linear(heads, heads) for _ in range(2)]
        for i, fc in enumerate(fcs):
            fc.load_state_dict(seeded_state_dict(fc, seed + 1 + i))
    return attn, fcs


def _run_attn(attn, fcs, x, mask, dtype):
    proj = {}
    if fcs is not None:
        proj = {k: (lambda fc: (lambda t: torch.nn.functional.linear(
            t.to(attn.dtype), fc.weight.to(attn.dtype), fc.bias.to(attn.dtype))))(fc)
            for k, fc in zip(("proj_l", "proj_w"), fcs)}
    m = None if mask is None else torch.from_numpy(mask.copy())
    with torch.no_grad():
        return attn(torch.tensor(x), m, **proj).float().numpy()


def _jax_attn(attn, fcs, x, mask, dim, window, heads, dtype):
    xj = jnp.asarray(x).astype(dtype)
    if fcs is None:
        jm = jswin.SwinWindowAttention(dim, window, heads, dtype=dtype)
        return np.asarray(jm.apply(_attn_variables(attn), xj, mask=mask), np.float32)
    jm = _JaxAttnWithTransforms(dim, window, heads, dtype)
    return np.asarray(jm.apply(_attn_variables(attn, fcs), xj, mask), np.float32)


@pytest.mark.parametrize("transforms", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_window_attention_fp32_matches_jax(masked, transforms):
    dim, window, heads = 64, 7, 2
    attn, fcs = _attn_pair(dim, window, heads, jnp.float32, 3, transforms)
    x = np.random.default_rng(4).standard_normal((2, 14, 14, dim)).astype(np.float32)
    mask = swin.shifted_window_mask(14, 14, window, 3) if masked else None
    got = _run_attn(attn, fcs, x, mask, jnp.float32)
    want = _jax_attn(attn, fcs, x, mask, dim, window, heads, jnp.float32)
    # fp32 with sums in other orders; the kernel route scales the scores
    # where JAX scales q (one more rounding each)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("transforms", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_window_attention_bf16_against_jax(masked, transforms):
    """bf16 numerics of the two routes, against the JAX plain route.

    Without head transforms the port follows K1 (its plain version
    `window_attention_ref`): the fp32 scores are scaled, q is not. JAX's
    plain route rounds q*scale to bf16 first (`cream_tpu/nn/swin.py:133`),
    a relative error of up to 2^-9 in every score, which moves P and so the
    bf16 output (measured: 1 ulp at the largest |out|, ~60% of the elements
    differ). With head transforms the port mirrors the JAX route's rounding
    points (q scaled in bf16, proj_l/mask/softmax/proj_w in bf16); what is
    left is a softmax and sums taken in other orders (measured: 2 ulps).
    Bound for both: 4 bf16 ulps at the largest |out|."""
    dim, window, heads = 64, 7, 2
    attn, fcs = _attn_pair(dim, window, heads, jnp.bfloat16, 5, transforms)
    x = np.random.default_rng(6).standard_normal((2, 14, 14, dim)).astype(np.float32)
    x = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    mask = swin.shifted_window_mask(14, 14, window, 3) if masked else None
    got = _run_attn(attn, fcs, x, mask, jnp.bfloat16)
    want = _jax_attn(attn, fcs, x, mask, dim, window, heads, jnp.bfloat16)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    err = np.abs(got - want).max()
    assert err <= 4 * ulp, (err, ulp)


def test_swin_attend_pads_before_masking_as_jax():
    """A 10x10 map with window 7 and shift 3 (`tests/test_swin.py:119`):
    padded to 14x14 first, then rolled and masked on the padded grid."""
    dim, window, heads = 32, 7, 4
    attn, _ = _attn_pair(dim, window, heads, jnp.float32, 7, False)
    x = np.random.default_rng(0).random((2, 10, 10, dim)).astype(np.float32)
    jm = jswin.SwinWindowAttention(dim, window, heads)
    v = _attn_variables(attn)
    want = jswin.swin_attend(jnp.asarray(x), lambda wx, mask, proj_l, proj_w, train=False:
                             jm.apply(v, wx, mask=mask), window, 3)
    with torch.no_grad():
        got = swin.swin_attend(torch.from_numpy(x), attn, window, 3)
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="window"):      # built for another window
        swin.swin_attend(torch.from_numpy(x), attn, 5, 2)


def test_patch_merging_concat_order_matches_jax():
    """[(0,0),(1,0),(0,1),(1,1)] in (h, w): any other order of the four
    groups would mismatch, since the seeded LN and reduction weights differ
    per input channel."""
    m = swin.SwinPatchMerging(8, 16, device="cpu")
    sd = seeded_state_dict(m, 2)
    m.load_state_dict(sd)
    x = np.random.default_rng(3).standard_normal((2, 4, 6, 8)).astype(np.float32)
    v = {"params": {"norm": {"scale": _np(sd["norm.weight"]), "bias": _np(sd["norm.bias"])},
                    "reduction": {"kernel": _np(sd["reduction.weight"]).T}}}
    want = jswin.SwinPatchMerging(16).apply(v, jnp.asarray(x))
    with torch.no_grad():
        got = m(torch.from_numpy(x))
    assert got.shape == (2, 2, 3, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    swapped = swin.SwinPatchMerging(8, 16, device="cpu")
    sd2 = dict(sd, **{"norm.weight": sd["norm.weight"].roll(8)})   # (1,0) <-> (0,0)
    swapped.load_state_dict(sd2)
    with torch.no_grad():
        assert not torch.allclose(swapped(torch.from_numpy(x)), got, atol=1e-3)


# ---- models ----

NARROW_SWIN = dict(embed_dims=(32, 64, 64, 128), depths=(2, 2, 2, 2),
                   num_heads=(1, 2, 2, 4), window_sizes=7, num_classes=10)
# S3: per-layer heads, windows and MLP ratios, head_dim 32 != dim / heads
NARROW_S3 = dict(embed_dims=(32, 64, 64, 128), depths=(2, 2, 2, 2),
                 num_heads=((1, 2), (2, 2), (2, 3), (4, 4)),
                 window_sizes=((7, 7), (7, 4), (14, 14), (7, 7)),
                 mlp_ratios=((4.0, 3.0), 4.0, (2.0, 4.0), 4.0), head_dim=32,
                 num_classes=10)
NARROW_MINI = dict(embed_dims=(32, 64, 64, 128), depths=(2, 2, 6, 2),
                   num_heads=(1, 2, 2, 4), num_classes=10)


def _narrow_case(kind, img, share=2):
    if kind == "mini":
        m = MiniSwin(img_size=img, share_num=share, device="cpu", **NARROW_MINI)
        jm = JaxMiniSwin(share_num=share, **NARROW_MINI)
        depths = NARROW_MINI["depths"]
    else:
        cfg = NARROW_SWIN if kind == "swin" else NARROW_S3
        m = SwinTransformer(img_size=img, device="cpu", **cfg)
        jm = JaxSwin(**cfg)
        depths, share = cfg["depths"], None
    m.load_state_dict(seeded_state_dict(m, 5))
    return m.eval(), jm, _to_jax(m.state_dict(), depths, share)


# maps: img 64 -> 16, 8, 4, 2 (stage 0 padded to 21x21 and masked, stage 2
# a 4x4 window unshifted); img 128 -> 32, 16, 8, 4 (stage 2 padded to 14x14
# and masked); whole windows at 224 in the full-width tests
@pytest.mark.parametrize("kind,img,share", [
    ("swin", 64, 2), ("swin", 128, 2), ("s3", 64, 2), ("s3", 128, 2),
    ("mini", 64, 2), ("mini", 64, 6), ("mini", 128, 6),
])
def test_narrow_models_match_jax(kind, img, share):
    m, jm, variables = _narrow_case(kind, img, share)
    x = np.random.default_rng(7).standard_normal((2, img, img, 3)).astype(np.float32)
    want = jax.jit(jm.apply)(variables, jnp.asarray(x))
    got = predict(m, torch.from_numpy(x))
    # fp32 through ~10 blocks with sums in other orders
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_full_width_matches_jax(full_width):
    name, want = full_width
    m = create_model(name, device="cpu")
    m.load_state_dict(seeded_state_dict(m, WEIGHT_SEED))
    got = predict(m, torch.from_numpy(golden_input()))
    assert got.shape == (2, 1000) and got.dtype == torch.float32
    # fp32 through the full depth with sums in other orders
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def test_golden_file_matches_jax(full_width):
    name, want = full_width
    g = np.load(golden_path(name))
    assert int(g["input_seed"]) == INPUT_SEED and int(g["weight_seed"]) == WEIGHT_SEED
    assert g["logits"].shape == (2, 1000) and g["logits"].dtype == np.float32
    # the same JAX computation on the CPU that wrote the file
    np.testing.assert_allclose(want, g["logits"], atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", sorted(DEPTHS))
def test_param_count_equals_jax(name):
    assert name in list_models()
    m = create_model(name, device="cpu")
    shapes = jax.eval_shape(lambda: jax_create_model(name).init(
        jax.random.key(0), jnp.zeros((1, 224, 224, 3))))
    n_jax = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes["params"]))
    assert sum(p.numel() for p in m.parameters()) == n_jax


@pytest.mark.parametrize("name", ["s3_tiny", "swin_tiny", "mini_swin_tiny", "mini_swin_small"])
def test_state_dict_round_trip_is_exact(name):
    m = create_model(name, device="cpu")
    sd = seeded_state_dict(m, 3)
    variables = _to_jax(sd, DEPTHS[name], SHARE.get(name))
    inverse = mini_swin_state_dict_from_jax if name in SHARE else swin_state_dict_from_jax
    back = inverse(variables)
    assert set(back) == set(sd)
    for k in sd:
        assert back[k].dtype == sd[k].dtype and torch.equal(back[k], sd[k]), k
    m.load_state_dict(back, strict=True)


def test_load_pth_drops_the_rebuilt_buffers(tmp_path):
    """Released Swin/S3 files carry `relative_position_index` and, in the
    shifted blocks, `attn_mask`; the port rebuilds both."""
    m = create_model("s3_tiny", device="cpu")
    sd = seeded_state_dict(m, 2)
    extra = {"layers.0.blocks.0.attn.relative_position_index": torch.zeros(49, 49, dtype=torch.long),
             "layers.0.blocks.1.attn_mask": torch.zeros(64, 49, 49),
             "layers.2.blocks.0.attn.relative_position_index": torch.zeros(196, 196,
                                                                           dtype=torch.long)}
    torch.save({"model": {**sd, **extra}}, tmp_path / "s3.pth")
    got = load_pth(str(tmp_path / "s3.pth"))
    assert set(got) == set(sd)
    m.load_state_dict(got, strict=True)


def test_registry_options_windows_and_drop_path():
    m = create_model("s3_small", device="cpu")
    # stage 3 is 7x7: the window 14 is clipped to 7, so the table has 13^2 rows
    assert m.layers[3].blocks[0].attn.relative_position_bias_table.shape == (169, 24)
    assert m.layers[2].blocks[0].attn.relative_position_bias_table.shape == (729, 12)
    assert m.layers[0].blocks[0].attn.qkv.out_features == 3 * 3 * 32
    m = create_model("s3_tiny", device="cpu", drop_path_rate=0.3, use_kernel=False,
                     img_size=112)
    rates = [b.drop_path_rate for layer in m.layers for b in layer.blocks]
    np.testing.assert_allclose(rates, [0.3 * i / 11 for i in range(12)])
    assert m.img_size == 112 and not any(
        a.use_kernel for a in m.modules() if isinstance(a, swin.SwinWindowAttention))
    assert create_model("s3_tiny", device="cpu").layers[0].blocks[1].drop_path_rate == \
        pytest.approx(0.1 / 11)            # SwinTransformer's default, as in JAX
    mini = create_model("mini_swin_tiny", device="cpu")
    assert [len(layer.blocks) for layer in mini.layers] == [1, 1, 1, 1]
    assert len(mini.layers[2].blocks[0].norm1_list) == 6
    with pytest.raises(ValueError, match="NHWC"):
        m(torch.zeros(1, 224, 224, 3))


def test_plain_attention_switch_covers_swin():
    m = create_model("s3_tiny", device="cpu", img_size=64)
    use_plain_attention(m)
    assert not any(a.use_kernel for a in m.modules()
                   if isinstance(a, swin.SwinWindowAttention))


# ---- training ----

LR = dict(base_lr=1e-3, warmup_steps=1, total_steps=5, warmup_init_lr=1e-4,
          min_lr=1e-5)


def _batch(seed, batch=4, img=64, num_classes=10):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, img, img, 3)).astype(np.float32)
    return x, np.eye(num_classes, dtype=np.float32)[rng.integers(0, num_classes, batch)]


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(jm):
    """value_and_grad of the soft-target loss over `jm`'s train forward,
    jitted once per module (the batch is an argument)."""
    def f(p, x, y):
        return jax_losses.soft_target_ce(jm.apply({"params": p}, x, train=True), y)
    return jax.jit(jax.value_and_grad(f))


def _jax_loss_and_grads(jm, params, x, y):
    return _jax_value_and_grad(jm)(params, x, y)


def _port_tree(tensors, depths):
    return convert_swin(_np_sd(tensors), depths=depths)["params"]


def test_narrow_s3_three_train_steps_match_jax():
    """3 AdamW steps of a narrow S3 (per-layer heads and windows, head dim
    32, the shift mask at stage 0) on a warmup + cosine schedule with
    clipping and an EMA, against JAX's `make_train_step`; drop path off."""
    cfg = dict(NARROW_S3, drop_path_rate=0.0)
    m = SwinTransformer(img_size=64, device="cpu", **cfg)
    m.load_state_dict(seeded_state_dict(m, 5))
    jm = JaxSwin(**cfg)
    depths, ema = cfg["depths"], 0.9
    params = convert_swin(_np_sd(m.state_dict()), depths=depths)["params"]
    jtx = jax_optim.make_adamw(jax_optim.cosine_schedule(*LR.values()), weight_decay=0.05,
                               clip_grad=5.0, params=params)
    jstate = JaxTrainState.create(params=params, tx=jtx, ema_decay=ema)
    jstep = jax_make_train_step(jm, loss_fn=jax_losses.soft_target_ce, donate=False)
    tx = optim.make_adamw(optim.cosine_schedule(*LR.values()), weight_decay=0.05,
                          clip_grad=5.0, params=dict(m.named_parameters()))
    state = TrainState(m, tx, ema_decay=ema)
    step = make_train_step(loss_fn=losses.soft_target_ce)
    lrs = []
    for i in range(3):
        x, y = _batch(10 + i)
        _, _, grads = loss_and_grads(m, {"image": torch.from_numpy(x),
                                         "label": torch.from_numpy(y)}, losses.soft_target_ce)
        _, jgrads = _jax_loss_and_grads(jm, jstate.params, jnp.asarray(x), jnp.asarray(y))
        lrs.append(state.tx.lr())
        state, metrics = step(state, {"image": torch.from_numpy(x), "label": torch.from_numpy(y)})
        jstate, jmetrics = jstep(jstate, {"image": jnp.asarray(x), "label": jnp.asarray(y)},
                                 jax.random.key(0))
        np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(metrics["grad_norm"]), float(jmetrics["grad_norm"]),
                                   rtol=1e-5)
        got, want = _leaves(_port_tree(grads, depths)), _leaves(jgrads)
        assert set(got) == set(want)
        for k in want:            # relative L2 1e-4, every tensor (no BN here)
            err = np.linalg.norm(got[k] - want[k])
            assert err <= 1e-4 * np.linalg.norm(want[k]) + 1e-7 * float(jmetrics["grad_norm"]), \
                (k, err)
    assert float(metrics["grad_norm"]) > 0
    # Adam's first update is ~lr*sign(g): an element whose grad sits at
    # float noise can move by up to 2*lr either way
    tol = 2 * sum(lrs)
    got = _leaves(_port_tree(state.params, depths))
    for k, w in _leaves(jstate.params).items():
        np.testing.assert_allclose(got[k], w, atol=tol, rtol=0, err_msg=k)
    got_ema = _leaves(_port_tree(state.ema_params, depths))
    for k, w in _leaves(jstate.ema_params).items():
        np.testing.assert_allclose(got_ema[k], w, atol=tol, rtol=0, err_msg=k)
    assert state.step == int(jstate.step) == 3


def _name_bridge(model, depths) -> dict[str, str]:
    """JAX param path -> port param name (a unique value per param carried
    through `convert_swin`)."""
    names = list(dict(model.named_parameters()))
    ids = {k: torch.full_like(p, float(i)) for i, (k, p) in enumerate(model.named_parameters())}
    bridge = {path: names[int(v.flat[0])]
              for path, v in _leaves(_port_tree(ids, depths)).items()}
    assert sorted(bridge.values()) == sorted(names)
    return bridge


def _golden_batch():
    rng = np.random.default_rng(INPUT_SEED)
    x = rng.standard_normal((2, 224, 224, 3)).astype(np.float32)
    return x, np.eye(1000, dtype=np.float32)[rng.integers(0, 1000, 2)]


def jax_s3_tiny_train_golden() -> dict:
    """One fp32 JAX train step of s3_tiny (drop path 0) on the seeded
    weights: loss, grad_norm and per-param grad norms by port param name."""
    port = create_model("s3_tiny", device="cpu")
    params = convert_swin(_np_sd(seeded_state_dict(port, WEIGHT_SEED)))["params"]
    jm = jax_create_model("s3_tiny", drop_path_rate=0.0)
    x, y = _golden_batch()
    loss, grads = _jax_loss_and_grads(jm, params, jnp.asarray(x), jnp.asarray(y))
    bridge = _name_bridge(port, DEPTHS["s3_tiny"])
    norms = {bridge[p]: float(np.linalg.norm(g)) for p, g in _leaves(grads).items()}
    names = sorted(norms)
    return {"loss": np.float32(loss), "grad_norm": np.float32(optax.global_norm(grads)),
            "names": np.asarray(names),
            "grad_norms": np.asarray([norms[n] for n in names], np.float32),
            "input_seed": np.int64(INPUT_SEED), "weight_seed": np.int64(WEIGHT_SEED)}


def test_full_width_s3_tiny_train_step_matches_jax_golden():
    g = np.load(TRAIN_GOLDEN)
    assert int(g["input_seed"]) == INPUT_SEED and int(g["weight_seed"]) == WEIGHT_SEED
    m = create_model("s3_tiny", device="cpu", drop_path_rate=0.0)
    m.load_state_dict(seeded_state_dict(m, WEIGHT_SEED))
    x, y = _golden_batch()
    loss, _, grads = loss_and_grads(m, {"image": torch.from_numpy(x),
                                        "label": torch.from_numpy(y)}, losses.soft_target_ce)
    assert sorted(grads) == list(g["names"])
    # fp32 through the full depth and back, sums in other orders
    np.testing.assert_allclose(float(loss), float(g["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(optim.global_norm(grads.values())),
                               float(g["grad_norm"]), rtol=1e-4)
    got = np.asarray([float(grads[n].norm()) for n in g["names"]])
    np.testing.assert_allclose(got, g["grad_norms"], rtol=1e-3,
                               atol=1e-7 * float(g["grad_norm"]))


def test_train_cli_runs_s3_tiny(tmp_path, capsys):
    from cream_tpu_torch.cli import train
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        train.main(["--device", "cpu", "model.name=s3_tiny", "model.dtype=float32",
                    "model.img_size=64", "data.img_size=64", "data.dataset=synthetic",
                    "data.batch_size=16", "data.num_workers=2", "train.epochs=1",
                    "train.warmup_epochs=0", "model.drop_path_rate=0.2", f"output={tmp_path}"])
    finally:
        torch.set_num_threads(n)
    out = capsys.readouterr().out
    assert "epoch 0 [0/4]" in out and "epoch 0 done" in out


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    DATA.mkdir(parents=True, exist_ok=True)
    for name in FULL:
        np.savez(golden_path(name), logits=jax_logits(name).astype(np.float32),
                 input_seed=np.int64(INPUT_SEED), weight_seed=np.int64(WEIGHT_SEED))
        print(f"wrote {golden_path(name)}")
    np.savez_compressed(TRAIN_GOLDEN, **jax_s3_tiny_train_golden())
    print(f"wrote {TRAIN_GOLDEN}")
