"""cream_tpu_torch TinyViT vs the JAX package's, on shared seeded weights.

Weights: `seeded_state_dict` on the port's model, carried to the JAX model by
`cream_tpu.zoo.import_torch.convert_tinyvit`. Inputs: numpy seeds.

Regenerate the golden file (JAX fp32 logits of TinyViT-21M-224) with
    python tests/test_torch_tinyvit.py
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cream_tpu.models import create_model as jax_create_model
from cream_tpu.models.tinyvit import TinyViT as JaxTinyViT
from cream_tpu.zoo.import_torch import convert_tinyvit
from cream_tpu_torch.cli.inference import predict
from cream_tpu_torch.cli.speed_test import throughput
from cream_tpu_torch.core.config import Config
from cream_tpu_torch.models import create_model, list_models
from cream_tpu_torch.models.tinyvit import TinyViT
from cream_tpu_torch.zoo.load import seeded_state_dict, state_dict_from_jax
from torch_threads import one_torch_thread_module  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "data" / "torch_port" / "tinyvit_21m_224_seed0.npz"
WEIGHT_SEED, INPUT_SEED = 0, 1


def _np_sd(sd):
    return {k: v.numpy() for k, v in sd.items()}


def golden_input(seed: int = INPUT_SEED, batch: int = 2) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (batch, 224, 224, 3)).astype(np.float32)


def jax_tinyvit21m_logits() -> np.ndarray:
    """JAX package's fp32 TinyViT-21M-224 logits on the seeded weights."""
    port = create_model("tiny_vit_21m_224", device="cpu")
    variables = convert_tinyvit(_np_sd(seeded_state_dict(port, WEIGHT_SEED)))
    jm = jax_create_model("tiny_vit_21m_224")
    return np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(golden_input())))


@pytest.fixture(scope="module")
def jax_21m_logits():
    return jax_tinyvit21m_logits()


def test_state_dict_round_trip_is_exact():
    m = create_model("tiny_vit_21m_224", device="cpu")
    sd = seeded_state_dict(m, 3)
    back = state_dict_from_jax(convert_tinyvit(_np_sd(sd)))
    assert set(back) == set(sd)
    for k in sd:
        assert back[k].dtype == sd[k].dtype, k
        assert torch.equal(back[k], sd[k]), k
    m.load_state_dict(back, strict=True)


@pytest.mark.parametrize("name", ["tiny_vit_5m_224", "tiny_vit_11m_224",
                                  "tiny_vit_21m_224", "tiny_vit_21m_384",
                                  "tiny_vit_21m_512"])
def test_param_count_equals_jax(name):
    assert name in list_models("tiny_vit")
    m = create_model(name, device="cpu")
    size = m.img_size
    shapes = jax.eval_shape(lambda: jax_create_model(name).init(
        jax.random.key(0), jnp.zeros((1, size, size, 3))))
    n_jax = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes["params"]))
    assert sum(p.numel() for p in m.parameters()) == n_jax


NARROW = dict(embed_dims=(32, 32, 64, 64), depths=(1, 2, 1, 1),
              num_heads=(1, 1, 2, 2), window_sizes=(7, 7, 14, 7), num_classes=10)


@pytest.mark.parametrize("img", [112, 100])       # 100: stage 1 is 13x13, padded windows
def test_narrow_tinyvit_matches_jax(img):
    m = TinyViT(img_size=img, device="cpu", **NARROW).eval()
    sd = seeded_state_dict(m, 5)
    m.load_state_dict(sd)
    x = np.random.default_rng(7).standard_normal((2, img, img, 3)).astype(np.float32)
    variables = convert_tinyvit(_np_sd(sd), depths=NARROW["depths"])
    want = jax.jit(JaxTinyViT(**NARROW).apply)(variables, jnp.asarray(x))
    got = predict(m, torch.from_numpy(x))
    # fp32 through ~20 layers with sums in other orders
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_full_width_21m_matches_jax(jax_21m_logits):
    m = create_model("tiny_vit_21m_224", device="cpu")
    m.load_state_dict(seeded_state_dict(m, WEIGHT_SEED))
    got = predict(m, torch.from_numpy(golden_input()))
    assert got.shape == (2, 1000) and got.dtype == torch.float32
    # fp32 through the full depth with sums in other orders (measured 3e-6)
    np.testing.assert_allclose(got.numpy(), jax_21m_logits, atol=1e-4, rtol=1e-4)


def test_golden_file_matches_jax(jax_21m_logits):
    g = np.load(GOLDEN)
    assert int(g["input_seed"]) == INPUT_SEED and int(g["weight_seed"]) == WEIGHT_SEED
    assert g["logits"].shape == (2, 1000) and g["logits"].dtype == np.float32
    # the same JAX computation on the CPU that wrote the file
    np.testing.assert_allclose(jax_21m_logits, g["logits"], atol=1e-5, rtol=0)


def test_port_imports_no_jax():
    """Every module of the port, found by walking the package, imports
    neither jax, flax nor the JAX package."""
    code = ("import pkgutil, importlib, sys, cream_tpu_torch; "
            "names = [m.name for m in pkgutil.walk_packages(cream_tpu_torch.__path__, "
            "'cream_tpu_torch.')]; "
            "[importlib.import_module(n) for n in names]; "
            "assert len(names) > 30 and 'cream_tpu_torch.ops.mbconv' in names, names; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'cream_tpu')]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p))
    subprocess.run([sys.executable, "-c", code], check=True, env=env, cwd=REPO)


def test_cuda_request_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        create_model("tiny_vit_5m_224", device="cuda")


def test_model_rejects_unported_options_and_train_mode():
    """Every option of the JAX model is ported: pin_layouts (K11) and
    remat_stem (stage 0 only; its parity is held in
    test_torch_image_folder.py). Train mode is ported: it runs without a
    generator only where it draws nothing (TinyViT-5M has drop path 0), and
    refuses to draw without one."""
    assert create_model("tiny_vit_5m_224", device="cpu", pin_layouts=True).pin_layouts
    m = create_model("tiny_vit_5m_224", device="cpu", remat_stem=True)
    assert [layer.remat for layer in m.layers] == [True, False, False, False]
    m = create_model("tiny_vit_5m_224", device="cpu", img_size=64).train()
    assert m(torch.zeros(2, 64, 64, 3)).shape == (2, 1000)
    m = create_model("tiny_vit_21m_224", device="cpu", img_size=64).train()
    with pytest.raises(ValueError, match="generator"):
        m(torch.zeros(2, 64, 64, 3))


def test_throughput_needs_a_card():
    m = create_model("tiny_vit_5m_224", device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        throughput(m, 1, 224, torch.float32, 1)


@pytest.mark.parametrize("opts", [
    [],
    ["model.name=tiny_vit_5m_224", "data.batch_size=64", "train.base_lr=2e-3"],
    ["model.dtype=float32", "data.crop=false", "model.drop_path_rate=0.1"],
])
def test_config_matches_jax(opts):
    from cream_tpu.core.config import Config as JaxConfig
    assert Config.from_yaml(None, opts).to_dict() == JaxConfig.from_yaml(None, opts).to_dict()


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    GOLDEN.parent.mkdir(parents=True, exist_ok=True)
    np.savez(GOLDEN, logits=jax_tinyvit21m_logits().astype(np.float32),
             input_seed=np.int64(INPUT_SEED), weight_seed=np.int64(WEIGHT_SEED))
    print(f"wrote {GOLDEN}")
