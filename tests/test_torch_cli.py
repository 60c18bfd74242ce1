"""cream_tpu_torch's host-side pieces: eval preprocessing, .pth loading and
the inference CLI, against the JAX package where it has a counterpart.
Images and weights come from numpy seeds.
"""
import dataclasses

import numpy as np
import pytest
import torch
from PIL import Image

from cream_tpu.data import transforms as jax_transforms
from cream_tpu_torch.cli import inference
from cream_tpu_torch.data import transforms
from cream_tpu_torch.models import create_model
from cream_tpu_torch.zoo.load import load_pth, seeded_state_dict
from torch_threads import one_torch_thread_module  # noqa: F401


def _image(seed, w, h):
    rgb = np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)
    return Image.fromarray(rgb)


@pytest.mark.parametrize("img_size,crop,clip", [(224, True, False), (384, False, False),
                                                (224, True, True)])
def test_eval_preprocess_config_matches_jax(img_size, crop, clip):
    got = transforms.eval_preprocess_config(img_size, crop=crop, clip=clip)
    want = jax_transforms.eval_preprocess_config(img_size, crop=crop, clip=clip)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("w,h", [(300, 257), (257, 300), (256, 256), (500, 375)])
def test_preprocess_pil_matches_jax(w, h):
    img = _image(w * h, w, h)
    cfg = transforms.eval_preprocess_config(224)
    got = transforms.preprocess_pil(img, cfg)
    want = jax_transforms.preprocess_pil(img, jax_transforms.eval_preprocess_config(224))
    assert got.shape == (224, 224, 3) and got.dtype == np.float32
    # the same PIL resize and the same float32 arithmetic: bit-identical
    np.testing.assert_array_equal(got, want)


def test_load_pth_drops_index_buffers(tmp_path):
    m = create_model("tiny_vit_5m_224", device="cpu")
    sd = seeded_state_dict(m, 2)
    # released checkpoints nest the weights under "model" and carry the
    # attention index tables, which the model rebuilds
    extra = {"layers.1.blocks.0.attn.attention_bias_idxs": torch.zeros(49, 49, dtype=torch.long)}
    torch.save({"model": {**sd, **extra}}, tmp_path / "ckpt.pth")
    got = load_pth(str(tmp_path / "ckpt.pth"))
    assert set(got) == set(sd)
    m.load_state_dict(got, strict=True)
    assert all(torch.equal(m.state_dict()[k], sd[k]) for k in sd)


def test_inference_cli_top5(tmp_path, capsys):
    m = create_model("tiny_vit_5m_224", device="cpu")
    sd = seeded_state_dict(m, 4)
    m.load_state_dict(sd)
    torch.save(sd, tmp_path / "w.pth")
    _image(11, 320, 240).save(tmp_path / "img.png")
    top5 = inference.main(["--image", str(tmp_path / "img.png"),
                           "--torch-ckpt", str(tmp_path / "w.pth"), "--device", "cpu",
                           "model.name=tiny_vit_5m_224", "model.dtype=float32"])
    x = transforms.preprocess_pil(Image.open(tmp_path / "img.png"),
                                  transforms.eval_preprocess_config(224))
    logits = inference.predict(m, torch.from_numpy(x)[None])
    # the CLI is predict() on the preprocessed image with the checkpoint's weights
    np.testing.assert_array_equal(top5, torch.topk(logits[0], 5).indices.numpy())
    assert capsys.readouterr().out.count("top") == 5


def test_profiler_names_every_cuda_kernel():
    """`cli.profile_step` files each `__global__` function of `csrc/` under
    its kernel's K number, not under a library kind, in the name the
    profiler records (`void (anonymous namespace)::name<T>(...)`)."""
    import re
    from pathlib import Path

    from cream_tpu_torch.cli.profile_step import kind_of
    csrc = Path(__file__).resolve().parent.parent / "cream_tpu_torch" / "csrc"
    text = "\n".join(p.read_text() for p in sorted(csrc.glob("*.cu")))
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(", text)
    assert len(names) >= 16, names
    kinds = {n: kind_of(f"void (anonymous namespace)::{n}<float>(float const*)") for n in names}
    assert all(k.startswith("K") for k in kinds.values()), kinds
