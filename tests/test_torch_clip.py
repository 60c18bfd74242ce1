"""cream_tpu_torch's TinyCLIP serving path (the CLIP two-tower models, the
CLIP classifier teacher, CLIP's ModifiedResNet, the CLIP loaders, the
tokenizer, zero-shot classification and the CLIs that run them) vs the JAX
package's, on shared seeded weights and numpy-seeded inputs.

Weights: `seeded_state_dict` on the port's model, carried to the JAX model
by `cream_tpu.zoo.import_torch.convert_clip` / `convert_clip_classifier` /
`convert_clip_rn` / `convert_clip_pruned` (the port's names are open_clip's,
which those read); the port's `*_state_dict_from_jax` bridges carry JAX
variables back. No TPU kernel lies on this path: both sides run plain math.

Regenerate the golden files (JAX fp32 features of tinyclip_vit_39m_16_text_19m,
with and without a 0/1 gate set, and of clip_resnet50, at B=2) with
    PYTHONPATH=.:tests python tests/test_torch_clip.py
"""
import dataclasses
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

from cream_tpu.data import tokenizer as jax_tokenizer
from cream_tpu.models import create_model as jax_create_model
from cream_tpu.models.clip import CLIP as JaxCLIP
from cream_tpu.models.clip import CLIPClassifier as JaxCLIPClassifier
from cream_tpu.models.clip import CLIPConfig as JaxCLIPConfig
from cream_tpu.models.clip import prune_clip
from cream_tpu.models.resnet import CLIPResNet as JaxCLIPResNet
from cream_tpu.models.resnet import ModifiedResNet as JaxModifiedResNet
from cream_tpu.train import zero_shot as jax_zero_shot
from cream_tpu.zoo import import_torch as jit
from cream_tpu_torch.cli import save_logits
from cream_tpu_torch.cli import zero_shot as zero_shot_cli
from cream_tpu_torch.cli.speed_test import pair_throughput
from cream_tpu_torch.data import tokenizer
from cream_tpu_torch.data.imagenet import SyntheticDataset, eval_loader
from cream_tpu_torch.models import create_model, list_models, registry
from cream_tpu_torch.models.clip import (CLIP, CLIP_CONFIGS, CLIPClassifier, CLIPConfig,
                                         CLIPTransformer)
from cream_tpu_torch.models.resnet import CLIPResNet, ModifiedResNet
from cream_tpu_torch.train import zero_shot
from cream_tpu_torch.zoo.load import (clip_classifier_state_dict_from_jax, clip_geometry,
                                      clip_resnet_state_dict_from_jax,
                                      clip_state_dict_from_jax, load_for_model,
                                      load_pruned_clip, normalize_clip_layout,
                                      seeded_state_dict)

import chip_smoke
from torch_threads import one_torch_thread_module  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
DATA = REPO / "tests" / "data" / "torch_port"
WEIGHT_SEED, INPUT_SEED = 0, 1
GOLDEN_CLIP = "tinyclip_vit_39m_16_text_19m"
GOLDEN_RN = "clip_resnet50"
NARROW = dict(embed_dim=64, vision_width=128, vision_layers=2, vision_patch=16,
              image_size=64, text_width=128, text_layers=2, text_heads=2,
              context_length=16, vocab_size=1000)
GATES = ("hidden_z", "heads_z", "mha_z", "intermediate_z", "ffn_z")


def golden_path(name: str) -> Path:
    return DATA / f"{name}_seed0.npz"


def _np(t):
    """A numpy copy (a view would follow the port's in-place updates)."""
    return t.detach().cpu().numpy().copy()


def _np_sd(sd):
    return {k: _np(v) for k, v in sd.items()}


def _seeded(model, seed=WEIGHT_SEED):
    model.load_state_dict(seeded_state_dict(model, seed))
    return model.eval()


def tokens(rng, batch: int, length: int, vocab: int) -> np.ndarray:
    """SOT, random ids, EOT (the highest id), zero padding."""
    out = np.zeros((batch, length), np.int32)
    for i in range(batch):
        n = int(rng.integers(3, length - 1))
        out[i, 0] = vocab - 2
        out[i, 1:n] = rng.integers(1, vocab - 2, n - 1)
        out[i, n] = vocab - 1
    return out


def pair_inputs(batch=3, size=64, length=16, vocab=1000, seed=INPUT_SEED):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((batch, size, size, 3)).astype(np.float32)
    return images, tokens(rng, batch, length, vocab)


def gate_set(rng, width, layers, heads, mlp, hard=False) -> dict:
    """Every gate set, some zeros (a quarter of the hidden channels, head 0
    of layer 0, the last layer's attention branch, a third of the MLP
    channels, layer 0's MLP branch); soft values elsewhere unless `hard`."""
    def draw(shape):
        return np.ones(shape, np.float32) if hard else \
            rng.uniform(0.3, 1.5, shape).astype(np.float32)
    g = {"hidden_z": draw(width), "heads_z": draw((layers, heads)), "mha_z": draw(layers),
         "intermediate_z": draw((layers, mlp)), "ffn_z": draw(layers)}
    g["hidden_z"][rng.choice(width, width // 4, replace=False)] = 0
    g["heads_z"][0, 0] = 0
    g["mha_z"][-1] = 0
    g["intermediate_z"][:, : mlp // 3] = 0
    g["ffn_z"][0] = 0
    return g


def _torch_gates(g):
    return None if g is None else {k: torch.from_numpy(v) for k, v in g.items()}


def _jax_gates(g):
    return None if g is None else {k: jnp.asarray(v) for k, v in g.items()}


def narrow_clip(dtype=torch.float32, quick_gelu=False, cfg=None, **ragged):
    cfg = cfg or CLIPConfig(**NARROW)
    return _seeded(CLIP(cfg, quick_gelu, dtype=dtype, device="cpu", **ragged))


def jax_clip_features(port, jdtype, images, text, vm=None, tm=None, quick_gelu=False):
    """The JAX CLIP's outputs on the port model's weights."""
    c = port.cfg
    ragged, variables = jit.convert_clip_pruned(_np_sd(port.state_dict()), c.vision_layers,
                                                c.text_layers)
    cfg = JaxCLIPConfig(**{**dataclasses.asdict(c), "embed_dim": ragged["embed_dim"],
                           "vision_width": ragged["vision_width"],
                           "text_width": ragged["text_width"]})
    jm = JaxCLIP(cfg=cfg, quick_gelu=quick_gelu, dtype=jdtype,
                 vision_heads=ragged["vision_heads"],
                 vision_mlp_widths=ragged["vision_mlp_widths"],
                 text_heads_per_layer=ragged["text_heads_per_layer"],
                 text_mlp_widths=ragged["text_mlp_widths"])
    out = jm.apply(variables, jnp.asarray(images).astype(jdtype), jnp.asarray(text),
                   image_masks=_jax_gates(vm), text_masks=_jax_gates(tm))
    return [np.asarray(o, np.float32) for o in out], ragged


def port_features(model, images, text, vm=None, tm=None):
    gates = () if vm is None and tm is None else (_torch_gates(vm), _torch_gates(tm))
    with torch.no_grad():
        out = model(torch.from_numpy(images), torch.from_numpy(text), *gates)
    return [o.float().numpy() for o in out]


def bf16_bound(ref: np.ndarray, ulps: int) -> float:
    """`ulps` bf16 ulps at the largest |ref|."""
    return ulps * 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)


# ---- the two-tower model ----

@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("quick_gelu", [False, True])
def test_narrow_clip_fp32_matches_jax(quick_gelu, gated):
    model = narrow_clip(quick_gelu=quick_gelu)
    images, text = pair_inputs()
    rng = np.random.default_rng(5)
    vm = gate_set(rng, 128, 2, 2, 512) if gated else None
    tm = gate_set(rng, 128, 2, 2, 512) if gated else None
    got = port_features(model, images, text, vm, tm)
    want, _ = jax_clip_features(model, jnp.float32, images, text, vm, tm, quick_gelu)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got[0], axis=-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("gated", [False, True])
def test_narrow_clip_bf16_matches_jax(gated):
    """bf16 on both sides: the features (unit norm) within 4 bf16 ulps at
    their largest magnitude (the matmuls' bf16 outputs and the fp32 sums
    round in another order), the scale exactly (fp32)."""
    model = narrow_clip(torch.bfloat16)
    images, text = pair_inputs()
    rng = np.random.default_rng(6)
    vm = gate_set(rng, 128, 2, 2, 512) if gated else None
    tm = gate_set(rng, 128, 2, 2, 512) if gated else None
    got = port_features(model, images, text, vm, tm)
    want, _ = jax_clip_features(model, jnp.bfloat16, images, text, vm, tm)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g, w, atol=bf16_bound(w, 4), rtol=0)
    assert got[2] == want[2]


def test_ragged_clip_matches_jax():
    """Per-layer heads (one layer's attention gone), an MLP width of 0 and a
    pruned hidden width, against JAX's ragged CLIP built by
    convert_clip_pruned from the port's state_dict."""
    cfg = CLIPConfig(**{**NARROW, "vision_width": 96})
    ragged = dict(vision_heads=(2, 0), vision_mlp_widths=(0, 300),
                  text_heads_per_layer=(1, 2), text_mlp_widths=(256, 0))
    model = narrow_clip(cfg=cfg, **ragged)
    assert not hasattr(model.visual.transformer.resblocks[1], "attn")
    assert not hasattr(model.visual.transformer.resblocks[0], "mlp")
    images, text = pair_inputs()
    want, geometry = jax_clip_features(model, jnp.float32, images, text)
    sd = model.state_dict()
    assert clip_geometry(sd, 2, 2) == {**geometry, "vision_heads": (2, 0),
                                       "vision_mlp_widths": (0, 300)}
    for g, w in zip(port_features(model, images, text), want):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5)


def test_clip_bridge_inverts_convert_clip():
    model = narrow_clip()
    sd = model.state_dict()
    back = clip_state_dict_from_jax(jit.convert_clip(_np_sd(sd), 2, 2))
    assert set(back) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k].numpy(), sd[k].numpy(), err_msg=k)


def _historical(sd: dict) -> dict:
    """open_clip names -> TinyCLIP's auto-weight-inheritance layout under DDP
    (`module._image_encoder.module.*`, `module._text_encoder.module.*`,
    `module._logit_scale.logit_scale`)."""
    out = {}
    for k, v in sd.items():
        if k.startswith("visual."):
            k = "_image_encoder.module." + k[len("visual."):]
        elif k == "logit_scale":
            k = "_logit_scale.logit_scale"
        else:
            k = "_text_encoder.module." + k
        out["module." + k] = v
    return out


def _jax_pruned():
    """JAX's prune_clip of the narrow CLIP (port seeded weights) under 0/1
    gates on both towers: (pruned model, its variables, full model, full
    variables, vision gates, text gates)."""
    port = narrow_clip(quick_gelu=True)
    cfg = JaxCLIPConfig(**NARROW)
    variables = jit.convert_clip(_np_sd(port.state_dict()), 2, 2)
    rng = np.random.default_rng(9)
    vm, tm = (gate_set(rng, 128, 2, 2, 512, hard=True) for _ in range(2))
    pm, pv = prune_clip(variables, cfg, vm, tm, quick_gelu=True)
    return pm, pv, JaxCLIP(cfg=cfg, quick_gelu=True), variables, vm, tm


def test_pruned_checkpoint_loader_matches_convert_clip_pruned(tmp_path):
    """A .pth written from JAX's prune_clip output in TinyCLIP's historical
    layout, wrapped as open_clip saves it: the port builds the same ragged
    model as JAX's convert_clip_pruned, whose features equal the JAX pruned
    model's and the JAX gated full model's."""
    pm, pv, full, fv, vm, tm = _jax_pruned()
    sd = clip_state_dict_from_jax(pv)
    path = tmp_path / "pruned.pt"
    torch.save({"epoch": 3, "state_dict": _historical(sd)}, path)
    model, loaded = load_pruned_clip(CLIPConfig(**NARROW), str(path), device="cpu",
                                     quick_gelu=True)
    model.load_state_dict(loaded)
    ragged, _ = jit.convert_clip_pruned(_np_sd(_historical(sd)), 2, 2)
    c = model.cfg
    assert clip_geometry(model.state_dict(), 2, 2) == ragged
    assert (c.vision_width, c.text_width) == (96, 96)
    images, text = pair_inputs()
    got = port_features(model, images, text)
    want = pm.apply(pv, jnp.asarray(images), jnp.asarray(text))
    gated = full.apply(fv, jnp.asarray(images), jnp.asarray(text),
                       image_masks=_jax_gates(vm), text_masks=_jax_gates(tm))
    for g, w, m in zip(got, want, gated):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(g, np.asarray(m), atol=1e-5, rtol=1e-5)


def test_hard_prune_of_the_smoke_matches_prune_clip():
    """chip_smoke's 0/1-gate pruning (the card's ragged check, the port's
    `prune_clip`) gives the state_dict JAX's prune_clip gives."""
    pm, pv, _, fv, vm, tm = _jax_pruned()
    want = clip_state_dict_from_jax(pv)
    got = chip_smoke.clip_hard_prune(clip_state_dict_from_jax(fv), vm, tm)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=0, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("key", [
    "module.visual.conv1.weight", "_image_encoder.module.ln_pre.weight",
    "module._image_encoder.module.transformer.resblocks.0.attn.in_proj_weight",
    "_text_encoder.module.token_embedding.weight",
    "module._text_encoder.module.transformer.resblocks.1.mlp.c_fc.bias",
    "image_encoder_without_ddp.module.proj", "text_encoder_without_ddp.module.ln_final.bias",
    "_logit_scale.logit_scale", "module._logit_scale.logit_scale", "logit_scale",
    "text_projection", "visual.positional_embedding"])
def test_normalize_clip_layout_matches_jax(key):
    assert normalize_clip_layout({key: 0}) == jit.normalize_clip_layout({key: 0})


def test_load_for_model_takes_historical_layouts_and_refuses_a_pruned_one(tmp_path):
    model = narrow_clip()
    sd = model.state_dict()
    wi = {k.replace("module._image_encoder", "image_encoder_without_ddp")
          .replace("module._text_encoder", "text_encoder_without_ddp"): v
          for k, v in _historical(sd).items()}
    for i, layout in enumerate((_historical(sd), wi)):
        path = tmp_path / f"{i}.pt"
        torch.save({"state_dict": {**layout, "input_resolution": torch.tensor(64)}}, path)
        loaded = load_for_model(model, str(path))
        assert set(loaded) == set(sd)
        assert all(torch.equal(loaded[k], sd[k]) for k in sd)
    pruned = {k: v for k, v in sd.items() if ".resblocks.1.mlp." not in k
              and ".resblocks.1.ln_2." not in k}
    with pytest.raises(ValueError, match="load_pruned_clip"):
        load_for_model(model, pruned)


def test_remat_gives_the_same_features_and_grads():
    """remat=True (each block recomputed in the backward) against
    remat=False on the same weights and gates: bit-identical features and
    grads of every parameter and gate."""
    images, text = (torch.from_numpy(x) for x in pair_inputs())
    rng = np.random.default_rng(5)
    vm, tm = (gate_set(rng, 128, 2, 2, 512) for _ in range(2))
    out = []
    for remat in (False, True):
        model = narrow_clip(remat=remat)
        assert all(m.remat == remat for m in model.modules() if isinstance(m, CLIPTransformer))
        gates = [{k: torch.from_numpy(v).requires_grad_() for k, v in g.items()}
                 for g in (vm, tm)]
        img, txt, scale = model(images, text, *gates)
        loss = (img * txt).sum() * scale
        leaves = [*model.parameters(), *gates[0].values(), *gates[1].values()]
        out.append([img, txt, *torch.autograd.grad(loss, leaves)])
    for a, b in zip(*out):
        assert torch.equal(a, b)


# ---- the classifier teacher and the ResNet towers ----

def test_narrow_clip_classifier_matches_jax():
    cfg = CLIPConfig(**NARROW)
    model = _seeded(CLIPClassifier(cfg, num_classes=12, quick_gelu=True, device="cpu"))
    sd = _np_sd(model.state_dict())
    variables = jit.convert_clip_classifier(sd, vision_layers=2)
    back = clip_classifier_state_dict_from_jax(variables)
    assert all(np.array_equal(back[k].numpy(), sd[k]) for k in sd) and set(back) == set(sd)
    images, _ = pair_inputs()
    jm = JaxCLIPClassifier(cfg=JaxCLIPConfig(**NARROW), num_classes=12, quick_gelu=True)
    want = np.asarray(jm.apply(variables, jnp.asarray(images)))
    with torch.no_grad():
        got = model(torch.from_numpy(images)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


RN_NARROW = dict(layers=(2, 1, 1, 1), embed_dim=32, heads=8, image_size=64, width=16,
                 text_width=128, text_layers=2, text_heads=2, context_length=16,
                 vocab_size=1000)


def test_narrow_clip_resnet_matches_jax():
    """The RN two-tower CLIP with eval BN (every stage's first block
    downsamples: by channels at stage 1, avg-pool + channels after) against
    JAX's CLIPResNet, and its bridge against convert_clip_rn."""
    model = _seeded(CLIPResNet(**RN_NARROW, device="cpu"))
    sd = _np_sd(model.state_dict())
    variables = jit.convert_clip_rn(sd, layers=RN_NARROW["layers"], text_layers=2)
    back = clip_resnet_state_dict_from_jax(variables)
    assert set(back) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k].numpy(), sd[k], err_msg=k)
    images, text = pair_inputs()
    jm = JaxCLIPResNet(**RN_NARROW)
    want = jax.jit(jm.apply)(variables, jnp.asarray(images), jnp.asarray(text))
    for g, w in zip(port_features(model, images, text), want):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-5, rtol=1e-5)


def test_narrow_resnet_tower_loads_from_a_clip_file_and_matches_jax(tmp_path):
    two = _seeded(CLIPResNet(**RN_NARROW, device="cpu"))
    path = tmp_path / "rn.pt"
    torch.save(two.state_dict(), path)
    tower = ModifiedResNet(RN_NARROW["layers"], 32, 8, 64, 16, device="cpu").eval()
    tower.load_state_dict(load_for_model(tower, str(path)))
    variables = jit.convert_clip_resnet_tower(_np_sd(two.state_dict()), RN_NARROW["layers"])
    images, _ = pair_inputs()
    want = jax.jit(JaxModifiedResNet(RN_NARROW["layers"], 32, 8, 64, 16).apply)(
        variables, jnp.asarray(images))
    with torch.no_grad():
        got = tower(torch.from_numpy(images)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)


CLIP_NAMES = ("tinyclip_vit_39m_16_text_19m", "tinyclip_vit_8m_16_text_3m",
              "tinyclip_vit_40m_32_text_19m", "tinyclip_vit_61m_32_text_29m",
              "clip_vit_b_16", "clip_vit_b_32", "clip_vit_b_16_classifier",
              "clip_vit_b_32_classifier", "clip_vit_large14_224_classifier",
              "clip_resnet50", "clip_resnet101", "clip_resnet50_tower",
              "clip_resnet101_tower")


def test_every_clip_name_is_registered():
    assert sorted(list_models("clip") + list_models("tinyclip")) == sorted(CLIP_NAMES)


@pytest.mark.parametrize("name", CLIP_NAMES)
def test_param_count_equals_jax(name):
    port = create_model(name, device="meta")
    jm = jax_create_model(name)
    img = jnp.zeros((1, 224, 224, 3))
    args = (img, jnp.zeros((1, 77), jnp.int32)) if hasattr(port, "encode_text") else (img,)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), *args))["params"]
    want = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes))
    assert sum(p.numel() for p in port.parameters()) == want


# ---- full width, and the goldens of the card's smoke run ----

def golden_text(rng, batch: int = 2) -> np.ndarray:
    return tokens(rng, batch, 77, 49408)


def golden_gates(rng, model) -> tuple[dict, dict]:
    c = model.cfg
    return (gate_set(rng, c.vision_width, c.vision_layers, c.vision_width // 64,
                     4 * c.vision_width, hard=True),
            gate_set(rng, c.text_width, c.text_layers, c.text_heads, 4 * c.text_width,
                     hard=True))


def jax_golden(name: str) -> dict:
    """The JAX package's fp32 features on the port's seeded weights and
    the golden inputs (and, for the ViT CLIP, under a 0/1 gate set)."""
    port = create_model(name, device="cpu")
    sd = _np_sd(seeded_state_dict(port, WEIGHT_SEED))
    rng = np.random.default_rng(INPUT_SEED + 1)
    text = golden_text(rng)
    images = chip_smoke.clip_golden_images(INPUT_SEED)
    jm = jax_create_model(name)
    out = {"text": text, "input_seed": np.int64(INPUT_SEED),
           "weight_seed": np.int64(WEIGHT_SEED)}
    if name == GOLDEN_RN:
        variables = jit.convert_clip_rn(sd)
        img, txt, scale = jax.jit(jm.apply)(variables, images, text)
    else:
        c = port.cfg
        variables = jit.convert_clip(sd, c.vision_layers, c.text_layers)
        img, txt, scale = jax.jit(jm.apply)(variables, images, text)
        vm, tm = golden_gates(rng, port)
        gi, gt, _ = jax.jit(jm.apply)(variables, images, text, _jax_gates(vm), _jax_gates(tm))
        out.update(gated_image_features=np.asarray(gi), gated_text_features=np.asarray(gt),
                   **{f"vision_{k}": v for k, v in vm.items()},
                   **{f"text_{k}": v for k, v in tm.items()})
    out.update(image_features=np.asarray(img), text_features=np.asarray(txt),
               logit_scale=np.asarray(scale))
    return out


@pytest.fixture(scope="module")
def full_width_clip():
    return jax_golden(GOLDEN_CLIP)


def test_full_width_tinyclip_fp32_matches_jax_and_golden(full_width_clip):
    want = full_width_clip
    stored = np.load(golden_path(GOLDEN_CLIP))
    model = _seeded(create_model(GOLDEN_CLIP, device="cpu"))
    images = chip_smoke.clip_golden_images(int(stored["input_seed"]))
    np.testing.assert_array_equal(stored["text"], want["text"])
    got = port_features(model, images, want["text"])
    vm = {k: stored[f"vision_{k}"] for k in GATES}
    tm = {k: stored[f"text_{k}"] for k in GATES}
    gated = port_features(model, images, want["text"], vm, tm)
    for key, g in (("image_features", got[0]), ("text_features", got[1]),
                   ("gated_image_features", gated[0]), ("gated_text_features", gated[1])):
        np.testing.assert_allclose(g, want[key], atol=1e-5, rtol=1e-5, err_msg=key)
        np.testing.assert_allclose(stored[key], want[key], atol=1e-5, rtol=1e-5, err_msg=key)
    np.testing.assert_allclose(got[2], want["logit_scale"], rtol=1e-6)


def test_full_width_clip_resnet50_fp32_matches_golden():
    g = np.load(golden_path(GOLDEN_RN))
    model = _seeded(create_model(GOLDEN_RN, device="cpu"), int(g["weight_seed"]))
    got = port_features(model, chip_smoke.clip_golden_images(int(g["input_seed"])), g["text"])
    np.testing.assert_allclose(got[0], g["image_features"], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got[1], g["text_features"], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got[2], g["logit_scale"], rtol=1e-6)


def test_smoke_ragged_check_on_the_golden_gates():
    """The card's ragged check at the narrow width: the ragged model built
    from the hard-pruned state_dict equals the gated full model."""
    model = narrow_clip(quick_gelu=True)
    rng = np.random.default_rng(11)
    vm, tm = (gate_set(rng, 128, 2, 2, 512, hard=True) for _ in range(2))
    pruned = chip_smoke.clip_hard_prune(model.state_dict(), vm, tm)
    ragged, sd = load_pruned_clip(model.cfg, pruned, device="cpu", quick_gelu=True)
    ragged.load_state_dict(sd)
    images, text = pair_inputs()
    for g, w in zip(port_features(ragged, images, text),
                    port_features(model, images, text, vm, tm)):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5)


def test_pair_timing_refuses_a_cpu_model():
    with pytest.raises(RuntimeError, match="CUDA"):
        pair_throughput(narrow_clip(), 2)


# ---- the tokenizer ----

@pytest.fixture(scope="module")
def merges_file(tmp_path_factory):
    names, templates = zero_shot.openai_imagenet_constants()
    path = tmp_path_factory.mktemp("bpe") / "merges.txt.gz"
    tokenizer.write_merges(path, tokenizer.learn_merges(names[:300] + templates, 200))
    return str(path)


TEXTS = ["a photo of a cat.", "The Quick, brown fox; jumps!", "modern art — 1970s",
         "it's a dog's life, isn't it? We'll see; they'd've", "&amp;lt;b&amp;gt; &quot;x&quot;",
         "Ⅻ ٣ ² x²", "  tabs\tand\nnewlines  ", "naïve café — Ελληνικά 日本語",
         "<|startoftext|>hi<|endoftext|>", "word " * 40]


def test_tokenizer_gives_jax_ids(merges_file):
    port = tokenizer.SimpleTokenizer(merges_file)
    ref = jax_tokenizer.SimpleTokenizer(merges_file)
    assert (port.vocab_size, port.sot, port.eot) == (ref.vocab_size, ref.sot, ref.eot)
    for text in TEXTS:
        assert port.encode(text) == ref.encode(text), text
    np.testing.assert_array_equal(port(TEXTS), ref(TEXTS))
    np.testing.assert_array_equal(port(TEXTS, 16), ref(TEXTS, 16))


def test_tokenizer_truncates_with_eot_last(merges_file):
    port = tokenizer.SimpleTokenizer(merges_file)
    out = port(["word " * 100, "a cat"], context_length=12)
    assert out.shape == (2, 12) and out[0, -1] == port.eot and out[0, 0] == port.sot
    assert (out[0] != 0).all() and out[1, -1] == 0 and port.eot in out[1]


def test_tokenizer_decode_round_trip(merges_file):
    port = tokenizer.SimpleTokenizer(merges_file)
    ref = jax_tokenizer.SimpleTokenizer(merges_file)
    assert port.decode(port.encode("a painting of two dogs")).strip() == "a painting of two dogs"
    for s in TEXTS:
        assert port.decode(port.encode(s)) == ref.decode(ref.encode(s))


def test_tokenizer_missing_merges_file_raises(monkeypatch, tmp_path):
    monkeypatch.delenv("CLIP_BPE_PATH", raising=False)
    with pytest.raises(FileNotFoundError):
        tokenizer.SimpleTokenizer(str(tmp_path / "absent.txt.gz"))
    with pytest.raises(FileNotFoundError):
        tokenizer.SimpleTokenizer()


def test_tokenizer_imports_without_regex(monkeypatch):
    monkeypatch.setitem(sys.modules, "regex", None)
    spec = importlib.util.spec_from_file_location("tokenizer_without_regex",
                                                  tokenizer.__file__)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.split_words("it's 3 cats!") == ["it", "'s", "3", "cats", "!"]


# letters (Latin, Greek, CJK, the long s), numbers of each kind (Nd ٣,
# Nl Ⅻ, No ²), contractions, html entities, punctuation, whitespace and
# the characters `regex` treats apart (U+001C-U+001F, U+0345)
_PIECES = ["a", "Z", "s", "S", "ſ", "t", "re", "VE", "m", "LL", "d", "é", "ß", "Ω", "ω",
           "日", "本", "3", "٣", "Ⅻ", "²", "'", "'s", "'T", "'re", "'Ve", "'m", "'ll", "'D",
           "&amp;", "&lt;", "!", "?", ".", ",", "—", "-", "<|", "|>", "<|startoftext|>",
           "<|ENDOFTEXT|>", " ", "  ", "\t", "\n", "　", "\x1c", "\x1f", "\u0345",
           "\u0301", "😀"]


@settings(max_examples=400, deadline=None, derandomize=True, database=None)
@given(st.lists(st.sampled_from(_PIECES), max_size=16).map("".join))
def test_word_split_equals_jax_regex(text):
    assert tokenizer.split_words(text) == jax_tokenizer._WORD_RE.findall(text)
    cleaned = jax_tokenizer._clean(text)
    assert tokenizer.split_words(cleaned) == jax_tokenizer._WORD_RE.findall(cleaned)


def test_learned_merges_shorten_prompts(merges_file):
    port = tokenizer.SimpleTokenizer(merges_file)
    bytes_only = len("a photo of a goldfish.".encode()) + 1
    assert len(port.encode("a photo of a goldfish.")) < bytes_only
    assert port.vocab_size == 512 + 200 + 2


# ---- zero-shot ----

CLASSES = ["goldfish", "tabby cat", "fire truck", "aïve bird", "red fox"]


def _narrow_jax(model):
    variables = jit.convert_clip(_np_sd(model.state_dict()), 2, 2)
    return JaxCLIP(cfg=JaxCLIPConfig(**NARROW)), variables


def test_zero_shot_classifier_and_eval_match_jax(merges_file):
    model = narrow_clip()
    jm, variables = _narrow_jax(model)
    port_tok = tokenizer.SimpleTokenizer(merges_file)
    ref_tok = jax_tokenizer.SimpleTokenizer(merges_file)

    def port_text(t):
        with torch.no_grad():
            return model.encode_text(t)

    got = zero_shot.build_zero_shot_classifier(
        port_text, lambda texts: port_tok(texts, 16), CLASSES, batch_size=2, device="cpu")
    want = jax_zero_shot.build_zero_shot_classifier(
        jax.jit(lambda t: jm.apply(variables, t, method="encode_text")),
        lambda texts: ref_tok(texts, 16), CLASSES, batch_size=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    rng = np.random.default_rng(3)
    batches = [{"image": rng.standard_normal((4, 64, 64, 3)).astype(np.float32),
                "label": rng.integers(0, 5, 4).astype(np.int32)} for _ in range(3)]

    def port_image(x):
        with torch.no_grad():
            return model.encode_image(x)

    res = zero_shot.zero_shot_eval(port_image, got, (
        {"image": torch.from_numpy(b["image"]), "label": b["label"]} for b in batches))
    ref = jax_zero_shot.zero_shot_eval(
        jax.jit(lambda x: jm.apply(variables, x, method="encode_image")), want,
        ({"image": jnp.asarray(b["image"]), "label": b["label"]} for b in batches))
    assert res == ref


def test_zero_shot_eval_skips_padding():
    classifier = torch.eye(6)[:, :5]
    feats = torch.eye(6)[[0, 1, 2, 3]]
    res = zero_shot.zero_shot_eval(lambda x: x, classifier, [
        {"image": feats, "label": np.array([0, 1, -1, -1])}])
    assert res == {"zeroshot_top1": 100.0, "zeroshot_top5": 100.0, "n": 2}


def test_eval_loader_clip_norm():
    # crop=False at the images' own size: the resize and crop are the
    # identity, so only the normalisation differs
    ds = SyntheticDataset(n=3, img_size=8, num_classes=4)
    plain = next(eval_loader(ds, 3, 8, crop=False, num_workers=1))["image"]
    clip = next(eval_loader(ds, 3, 8, crop=False, clip_norm=True, num_workers=1))["image"]
    raw = np.stack([ds.load(i)[0] for i in range(3)]).astype(np.float32) / 255
    np.testing.assert_allclose(clip, (raw - np.float32([0.48145466, 0.4578275, 0.40821073]))
                               / np.float32([0.26862954, 0.26130258, 0.27577711]), rtol=1e-6)
    assert not np.allclose(plain, clip)


# ---- the CLIs on the CPU ----

def _cli_args(merges, names_file, *extra):
    return ["--device", "cpu", "--bpe", merges, "--classnames", str(names_file),
            "model.name=tinyclip_vit_8m_16_text_3m", "model.dtype=float32",
            'model.extra={"img_size": 64}', "model.num_classes=3", "data.img_size=64",
            "data.dataset=synthetic", "data.batch_size=16", *extra]


def test_zero_shot_cli_end_to_end(merges_file, tmp_path):
    names = tmp_path / "names.txt"
    names.write_text("goldfish\ntabby cat\nfire truck\n")
    res = zero_shot_cli.main(_cli_args(merges_file, names))
    assert res["n"] == 64 and 0 <= res["zeroshot_top1"] <= res["zeroshot_top5"] <= 100
    assert tuple(res["classifier"].shape) == (512, 3)
    np.testing.assert_allclose(torch.linalg.vector_norm(res["classifier"], dim=0), 1.0,
                               atol=1e-5)
    # the same seeded model, pruned, in a historical layout through --torch-ckpt
    model = _seeded(create_model("tinyclip_vit_8m_16_text_3m", device="cpu", img_size=64))
    sd = {k: v for k, v in model.state_dict().items()
          if not k.startswith(("transformer.resblocks.0.mlp.", "transformer.resblocks.0.ln_2.",
                               "visual.transformer.resblocks.1.attn.",
                               "visual.transformer.resblocks.1.ln_1."))}
    ckpt = tmp_path / "pruned.pt"
    torch.save({"state_dict": _historical(sd)}, ckpt)
    res = zero_shot_cli.main(_cli_args(merges_file, names, "--torch-ckpt", str(ckpt)))
    ragged, rsd = load_pruned_clip("tinyclip_vit_8m_16_text_3m", sd, device="cpu",
                                   img_size=64)
    ragged.load_state_dict(rsd)
    assert clip_geometry(ragged.state_dict(), 10, 3)["text_mlp_widths"] == (0, 1024, 1024)
    port_tok = tokenizer.SimpleTokenizer(merges_file)
    with torch.no_grad():
        want = zero_shot.build_zero_shot_classifier(
            ragged.encode_text, lambda t: port_tok(t, 77),
            ["goldfish", "tabby cat", "fire truck"], device="cpu")
    np.testing.assert_allclose(res["classifier"].numpy(), want.numpy(), atol=1e-6)


def test_zero_shot_cli_refusals(merges_file, tmp_path):
    names = tmp_path / "names.txt"
    names.write_text("goldfish\n")
    # image folders are read now (tests/test_torch_image_folder.py): a
    # missing one raises; images of another size are resized to the model's
    with pytest.raises(FileNotFoundError):
        zero_shot_cli.main(_cli_args(merges_file, names, "data.dataset=imagenet",
                                     f"data.data_path={tmp_path / 'absent'}"))
    res = zero_shot_cli.main(_cli_args(merges_file, names, "data.img_size=32"))
    assert res["n"] == 64 and tuple(res["classifier"].shape) == (512, 1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            zero_shot_cli.main(_cli_args(merges_file, names)[2:])


def test_save_logits_with_a_narrow_clip_teacher(tmp_path, monkeypatch):
    def narrow_clip_classifier(num_classes=1000, img_size=None, *, device,
                               dtype=torch.float32):
        return CLIPClassifier(CLIPConfig(**NARROW), num_classes, quick_gelu=True,
                              dtype=dtype, device=device)
    monkeypatch.setitem(registry._REGISTRY, "narrow_clip_classifier", narrow_clip_classifier)
    argv = ["--device", "cpu", "model.name=narrow_clip_classifier", "model.dtype=float32",
            "model.num_classes=40", "model.img_size=64", "data.img_size=64",
            "data.dataset=synthetic", "data.batch_size=8", "distill.logits_topk=5",
            "--allow-random", "--out", str(tmp_path / "store")]
    (saved,) = save_logits.main(argv)
    assert saved["records"] == 64
    (checked,) = save_logits.main(argv + ["--check"])
    assert checked["value_max_err"] <= 1e-3 and checked["index_miss_rate"] == 0.0


def test_registered_clip_factories_take_img_size():
    m = create_model("clip_vit_b_32_classifier", device="meta", num_classes=7, img_size=64)
    assert m.img_size == 64 and m.visual.positional_embedding.shape == (5, 768)
    assert create_model("clip_resnet50", device="meta").img_size == 224
    assert CLIP_CONFIGS["tinyclip_vit_39m_16_text_19m"].text_layers == 6


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    DATA.mkdir(parents=True, exist_ok=True)
    for name in (GOLDEN_CLIP, GOLDEN_RN):
        np.savez_compressed(golden_path(name), **jax_golden(name))
        print(f"wrote {golden_path(name)}")
