"""cream_tpu_torch EfficientViT vs the JAX package's, on shared seeded weights.

Weights: `seeded_state_dict` on the port's model, carried to the JAX model by
`cream_tpu.zoo.import_torch.convert_efficientvit`. Inputs: numpy seeds. On
the CPU the JAX module runs its XLA path, the reference for all three of the
port's attention routes (the K4/K5 routes run their kernels' plain versions
here).

Regenerate the golden file (JAX fp32 logits of EfficientViT-M5) with
    python tests/test_torch_efficientvit.py
"""
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cream_tpu.models import create_model as jax_create_model
from cream_tpu.models.efficientvit import CascadedGroupAttention as JaxCGA
from cream_tpu.zoo.import_torch import convert_efficientvit
from cream_tpu_torch.cli.inference import predict
from cream_tpu_torch.models import create_model, list_models
from cream_tpu_torch.models.efficientvit import _CONFIGS, CascadedGroupAttention
from cream_tpu_torch.zoo.load import (efficientvit_state_dict_from_jax, load_pth,
                                      seeded_state_dict)

from test_torch_cga import cga_variables
from torch_threads import one_torch_thread_module  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "data" / "torch_port" / "efficientvit_m5_seed0.npz"
WEIGHT_SEED, INPUT_SEED = 0, 1
ROUTES = ("cascade", "core", "plain")


def _np_sd(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _images(seed, batch, img):
    return np.random.default_rng(seed).standard_normal((batch, img, img, 3)).astype(np.float32)


def _variables(name, sd):
    cfg = _CONFIGS[name]
    return convert_efficientvit(_np_sd(sd), depths=cfg["depth"], num_heads=cfg["num_heads"])


def jax_logits(name: str, img: int, **kw) -> np.ndarray:
    """The JAX package's fp32 logits on the port's seeded weights (seed 0)
    for two images of input seed 1."""
    port = create_model(name, device="cpu", img_size=img, **kw)
    variables = _variables(name, seeded_state_dict(port, WEIGHT_SEED))
    jm = jax_create_model(name, img_size=img, **kw)
    return np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(_images(INPUT_SEED, 2, img))))


@pytest.fixture(scope="module")
def jax_cache():
    cache = {}

    def get(name, img, **kw):
        key = (name, img, tuple(sorted(kw.items())))
        if key not in cache:
            cache[key] = jax_logits(name, img, **kw)
        return cache[key]
    return get


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("name,img", [("efficientvit_m5", 224),   # windows 7/7/4
                                      ("efficientvit_m0", 96),    # windows 6/3/2
                                      ("efficientvit_m0", 256)])  # 16x16 map: 7x7 windows, padded
def test_logits_match_jax(jax_cache, name, img, route):
    m = create_model(name, device="cpu", img_size=img, attn_kernel=route)
    m.load_state_dict(seeded_state_dict(m, WEIGHT_SEED))
    got = predict(m, torch.from_numpy(_images(INPUT_SEED, 2, img)))
    assert got.shape == (2, 1000) and got.dtype == torch.float32
    # fp32 with sums in other orders; the K4 route folds BN into the weights
    # (measured <= 1.1e-6 on logits of max |.| ~ 2), the JAX kernel test's 1e-4
    np.testing.assert_allclose(got.numpy(), jax_cache(name, img), atol=1e-4, rtol=1e-4)


def test_golden_file_matches_jax(jax_cache):
    g = np.load(GOLDEN)
    assert int(g["input_seed"]) == INPUT_SEED and int(g["weight_seed"]) == WEIGHT_SEED
    assert g["logits"].shape == (2, 1000) and g["logits"].dtype == np.float32
    # the same JAX computation on the CPU that wrote the file
    np.testing.assert_allclose(jax_cache("efficientvit_m5", 224), g["logits"], atol=1e-5, rtol=0)


def test_distillation_head_matches_jax(jax_cache):
    m = create_model("efficientvit_m0", device="cpu", img_size=96, num_classes=10,
                     distillation=True)
    m.load_state_dict(seeded_state_dict(m, WEIGHT_SEED))
    assert {"head_dist.l.weight", "head_dist.bn.running_var"} <= set(m.state_dict())
    got = predict(m, torch.from_numpy(_images(INPUT_SEED, 2, 96)))
    # eval: the mean of the two heads
    np.testing.assert_allclose(
        got.numpy(), jax_cache("efficientvit_m0", 96, num_classes=10, distillation=True),
        atol=1e-4, rtol=1e-4)


def test_forward_pyramid_and_features_match_jax():
    name = "efficientvit_m0"
    m = create_model(name, device="cpu", num_classes=0)
    sd = seeded_state_dict(m, 2)
    m.load_state_dict(sd)
    variables = _variables(name, sd)
    jm = jax_create_model(name, num_classes=0)
    x = _images(3, 1, 224)
    want = jax.jit(lambda v, x: jm.apply(v, x, method="forward_pyramid"))(variables, jnp.asarray(x))
    with torch.inference_mode():
        got = m.forward_pyramid(torch.from_numpy(x))
        feats = m.forward_features(torch.from_numpy(x))
        pooled = m(torch.from_numpy(x))
    assert [tuple(t.shape) for t in got] == [(1, 14, 14, 64), (1, 7, 7, 128), (1, 4, 4, 192)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4)
    assert tuple(feats.shape) == (1, 4, 4, 192) and torch.equal(feats, got[-1])
    # no head: the pooled features
    assert tuple(pooled.shape) == (1, 192) and torch.allclose(pooled, feats.mean(dim=(1, 2)))


@pytest.mark.parametrize("name", sorted(_CONFIGS))
def test_param_count_equals_jax(name):
    assert name in list_models("efficientvit")
    m = create_model(name, device="cpu")
    shapes = jax.eval_shape(lambda: jax_create_model(name).init(
        jax.random.key(0), jnp.zeros((1, 224, 224, 3))))
    n_jax = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes["params"]))
    assert sum(p.numel() for p in m.parameters()) == n_jax


def test_state_dict_round_trip_is_exact():
    m = create_model("efficientvit_m5", device="cpu", distillation=True)
    sd = seeded_state_dict(m, 3)
    back = efficientvit_state_dict_from_jax(_variables("efficientvit_m5", sd))
    assert set(back) == set(sd)
    for k in sd:
        assert back[k].dtype == sd[k].dtype and torch.equal(back[k], sd[k]), k
    m.load_state_dict(back, strict=True)


def test_released_layout_loads(tmp_path):
    """Released EfficientViT files nest the weights under "model", keep the
    index buffers and store some 1x1 conv weights 2-D."""
    m = create_model("efficientvit_m0", device="cpu")
    sd = seeded_state_dict(m, 4)
    released = {k: (v[:, :, 0, 0] if k.endswith(".c.weight") and v.shape[2:] == (1, 1) else v)
                for k, v in sd.items()}
    assert sum(v.ndim == 2 and k.endswith(".c.weight") for k, v in released.items()) > 50
    released["blocks1.0.mixer.m.attn.attention_bias_idxs"] = torch.zeros(49, 49, dtype=torch.long)
    torch.save({"model": released}, tmp_path / "efficientvit_m0.pth")
    got = load_pth(str(tmp_path / "efficientvit_m0.pth"))
    assert set(got) == set(sd)
    m.load_state_dict(got, strict=True)
    assert all(torch.equal(m.state_dict()[k], sd[k]) for k in sd)


def test_unknown_route_and_wrong_size_raise():
    with pytest.raises(ValueError):
        create_model("efficientvit_m0", device="cpu", attn_kernel="other")
    with pytest.raises(ValueError):
        create_model("efficientvit_m0", device="cpu").set_attn_kernel("other")
    with pytest.raises(ValueError):                         # not the model's size
        create_model("efficientvit_m0", device="cpu", img_size=96).eval()(torch.zeros(1, 64, 64, 3))
    with pytest.raises(ValueError):
        create_model("efficientvit_m0", device="cpu", dw_kernel="other")
    # train mode runs (tests/test_torch_efficientvit_train.py holds it to JAX)
    # and refuses a wrong size as eval does
    m = create_model("efficientvit_m0", device="cpu", img_size=96).train()
    assert m(torch.zeros(2, 96, 96, 3)).shape == (2, 1000)
    with pytest.raises(ValueError):
        m(torch.zeros(2, 64, 64, 3))


def test_bf16_plain_cga_matches_jax_module():
    """The CGA module in bf16 on the plain route, against the JAX module in
    bf16 (its XLA path): the same rounding points (scores, exp, out)."""
    C, heads, ws, kernels = 192, 3, 7, (7, 5, 3, 3)
    m = CascadedGroupAttention(C, 16, heads, C / 48, ws, kernels, attn_kernel="plain",
                               device="cpu", dtype=torch.bfloat16).eval()
    m.load_state_dict(seeded_state_dict(m, 6))
    x = np.random.default_rng(6).standard_normal((8, ws, ws, C)).astype(np.float32)
    jm = JaxCGA(C, 16, heads, C / 48, ws, kernels, dtype=jnp.bfloat16)
    want = np.asarray(jax.jit(jm.apply)(cga_variables(m), jnp.asarray(x, jnp.bfloat16)),
                      np.float32)
    with torch.inference_mode():
        got = m(torch.from_numpy(x).bfloat16()).float().numpy()
    # bf16 convolutions, BN and einsums on both sides with fp32 sums in other
    # orders, and XLA may keep excess precision across a fused bf16 chain:
    # 4 bf16 ulps at the largest |out|
    top = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=4 * 2.0 ** (np.floor(np.log2(top)) - 7), rtol=0)


def test_inference_cli_takes_efficientvit(tmp_path, capsys):
    from PIL import Image

    from cream_tpu_torch.cli import inference
    from cream_tpu_torch.data import transforms
    rgb = np.random.default_rng(8).integers(0, 256, (240, 320, 3), dtype=np.uint8)
    Image.fromarray(rgb).save(tmp_path / "img.png")
    top5 = inference.main(["--image", str(tmp_path / "img.png"), "--device", "cpu",
                           "model.name=efficientvit_m0", "model.dtype=float32",
                           'model.extra={"attn_kernel": "core"}'])
    m = create_model("efficientvit_m0", device="cpu", attn_kernel="core")
    m.load_state_dict(seeded_state_dict(m, 0))          # the CLI's train.seed
    x = transforms.preprocess_pil(Image.open(tmp_path / "img.png"),
                                  transforms.eval_preprocess_config(224))
    logits = predict(m, torch.from_numpy(x)[None])
    np.testing.assert_array_equal(top5, torch.topk(logits[0], 5).indices.numpy())
    assert capsys.readouterr().out.count("top") == 5


def test_speed_cli_passes_model_options():
    from cream_tpu_torch.cli import speed_test
    assert speed_test.model_kwargs(["attn_kernel=plain", "distillation=true"]) == \
        {"attn_kernel": "plain", "distillation": True}
    with pytest.raises(ValueError):
        speed_test.model_kwargs(["attn_kernel"])
    with pytest.raises(ValueError):                     # reaches the model
        speed_test.main(["--models", "efficientvit_m0", "--device", "cpu", "attn_kernel=other"])
    with pytest.raises(RuntimeError, match="CUDA"):     # no CPU timing
        speed_test.main(["--models", "efficientvit_m0", "--device", "cpu", "--batch", "1",
                         "--iters", "1", "attn_kernel=plain"])


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    GOLDEN.parent.mkdir(parents=True, exist_ok=True)
    np.savez(GOLDEN, logits=jax_logits("efficientvit_m5", 224).astype(np.float32),
             input_seed=np.int64(INPUT_SEED), weight_seed=np.int64(WEIGHT_SEED))
    print(f"wrote {GOLDEN}")
