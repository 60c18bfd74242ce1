"""Every registered CLIP of the port against the JAX package's at full width:
the features (or the classifier's logits) in fp32 at B = 1 on the CPU, on
seeded weights carried to JAX by `cream_tpu.zoo.import_torch`; and which
of them split by heads over a model axis of 2 and of 4.

TinyCLIP-39M/16 and RN50 are held to stored goldens by
`tests/test_torch_clip.py`; this file takes the other names, whose tests
there check parameter counts only.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cream_tpu.models import create_model as jax_create_model
from cream_tpu.zoo import import_torch as jit
from cream_tpu_torch.core.tensor_parallel import ModelShard
from cream_tpu_torch.models import create_model
from cream_tpu_torch.models.clip import CLIP_CLASSIFIER_CONFIGS, CLIP_CONFIGS
from cream_tpu_torch.models.resnet import CLIP_RESNETS
from cream_tpu_torch.zoo.load import seeded_state_dict

from torch_threads import one_torch_thread_module  # noqa: F401

# the names of tests/test_torch_clip.py's CLIP_NAMES but its two goldens'
VARIANTS = ("tinyclip_vit_8m_16_text_3m", "tinyclip_vit_40m_32_text_19m",
            "tinyclip_vit_61m_32_text_29m", "clip_vit_b_16", "clip_vit_b_32",
            "clip_vit_b_16_classifier", "clip_vit_b_32_classifier",
            "clip_vit_large14_224_classifier", "clip_resnet101", "clip_resnet50_tower",
            "clip_resnet101_tower")
# over ~10 s a case on the CPU
SLOW = {"clip_vit_large14_224_classifier"}


def _variables(name: str, sd: dict, port) -> dict:
    if name.endswith("_tower"):
        return jit.convert_clip_resnet_tower(sd, CLIP_RESNETS[name[:-len("_tower")]][0])
    if name in CLIP_RESNETS:
        return jit.convert_clip_rn(sd, layers=CLIP_RESNETS[name][0], text_layers=12)
    if name.endswith("_classifier"):
        return jit.convert_clip_classifier(sd, port.cfg.vision_layers)
    return jit.convert_clip(sd, port.cfg.vision_layers, port.cfg.text_layers)


def _inputs(two_towers: bool):
    rng = np.random.default_rng(7)
    images = rng.standard_normal((1, 224, 224, 3)).astype(np.float32)
    if not two_towers:
        return (images,)
    text = np.zeros((1, 77), np.int32)
    n = 20
    text[0, 0], text[0, 1:n], text[0, n] = 49406, rng.integers(1, 49406, n - 1), 49407
    return images, text


@pytest.mark.parametrize("name", [pytest.param(n, marks=pytest.mark.slow) if n in SLOW else n
                                  for n in VARIANTS])
def test_clip_variant_fp32_matches_jax(name):
    """fp32, B = 1, 224 px (and 77 token ids): each output within 1e-5 of
    JAX's, relative to its largest magnitude."""
    port = create_model(name, device="cpu").eval()
    port.load_state_dict(seeded_state_dict(port, 0))
    sd = {k: v.numpy().copy() for k, v in port.state_dict().items()}
    args = _inputs(hasattr(port, "encode_text"))
    with torch.no_grad():
        got = port(*(torch.from_numpy(a) for a in args))
    want = jax.jit(jax_create_model(name).apply)(_variables(name, sd, port),
                                                 *(jnp.asarray(a) for a in args))
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * max(np.abs(w).max(), 1.0))


# the heads of the towers: TinyCLIP-61M/32's vision tower has 10 (width 640)
SPLITS = {2: set(CLIP_CONFIGS) | set(CLIP_CLASSIFIER_CONFIGS),
          4: (set(CLIP_CONFIGS) | set(CLIP_CLASSIFIER_CONFIGS)) - {"tinyclip_vit_61m_32_text_29m"}}


@pytest.mark.parametrize("size", sorted(SPLITS))
def test_which_clip_names_split_over_the_model_axis(size):
    """Every ViT CLIP and classifier splits over a model axis of 2; at 4
    all but TinyCLIP-61M/32, whose 10 vision heads refuse, naming the
    layer."""
    split = set()
    for name in sorted(set(CLIP_CONFIGS) | set(CLIP_CLASSIFIER_CONFIGS)):
        try:
            create_model(name, device="meta", model_shard=ModelShard(0, size))
        except ValueError as e:
            assert "visual.transformer.resblocks.0.attn heads" in str(e), e
            continue
        split.add(name)
    assert split == SPLITS[size]
