"""cream_tpu_torch's Pillow-free pixels against the JAX package's Pillow ones.

`data.pil_ops` against the Pillow calls the JAX modules make, exactly (0
levels); every `data.auto_augment` op, level map and augmenter against
`cream_tpu.data.auto_augment`, exactly, with the generator left in the same
state; `det_aug.make_train_transform` / `train_transform` and the eval
preprocessing against JAX's in float32, bit for bit; the BMP reader against
Pillow; the stored golden that `chip_smoke.py` holds the card's host to.

Regenerate the golden (`tests/data/torch_port/train_transform_seed0.npz`,
the JAX package's outputs) with
    PYTHONPATH=.:tests python tests/test_torch_data_aug.py
"""
import builtins
import hashlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image, ImageEnhance, ImageFilter, ImageOps

from cream_tpu.data import auto_augment as jax_aa
from cream_tpu.data import det_aug as jax_det_aug
from cream_tpu.data import transforms as jax_transforms
from cream_tpu_torch.data import auto_augment as aa
from cream_tpu_torch.data import det_aug, image_io, pil_ops, transforms
from torch_threads import one_torch_thread_module  # noqa: F401

GOLDEN = Path(__file__).resolve().parent / "data" / "torch_port" / "train_transform_seed0.npz"
# the golden's recipes: TrainAugConfig(), RandAugment m3 n2, the colour-jitter
# route (no auto_augment) and the eval preprocessing
GOLDEN_RECIPES = {"default": {}, "rand_m3_n2": {"auto_augment": "rand-m3-n2-mstd0.5"},
                  "jitter": {"auto_augment": ""}}
GOLDEN_SIZES = [(131, 97), (96, 96), (75, 75), (200, 33), (150, 211), (97, 163),
                (64, 300), (240, 180)]          # (W, H)
GOLDEN_SEEDS = [0, 1, 7, 12345]


def field(rng, h: int, w: int, noise: float = 6.0) -> np.ndarray:
    """A uint8 (h, w, 3) image: a low-frequency colour field, a hard-edged
    rectangle and a half-plane step, plus a little noise, so the histogram
    ops and the resamplers all have work."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.empty((h, w, 3))
    for c in range(3):
        fx, fy, ph = rng.uniform(0.005, 0.05, 2).tolist() + [rng.uniform(0, 6.3)]
        img[..., c] = 128 + 90 * np.sin(fx * xx * 6.3 + fy * yy * 6.3 + ph)
    x0, y0 = rng.integers(0, max(w, 1)), rng.integers(0, max(h, 1))
    img[y0:y0 + h // 3 + 1, x0:x0 + w // 3 + 1] = rng.integers(0, 256, 3)
    a, b = rng.normal(size=2)
    img[(a * (xx - w / 2) + b * (yy - h / 2)) > 0] *= rng.uniform(0.4, 0.9)
    img += rng.normal(0, noise, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def any_image(rng, h: int, w: int) -> np.ndarray:
    """A field, uniform noise or a narrow-range image (so autocontrast and
    equalize both stretch and leave alone)."""
    kind = int(rng.integers(4))
    if kind == 0:
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    if kind == 1:
        return rng.integers(90, 140, (h, w, 3), dtype=np.uint8)
    return field(rng, h, w)


def sizes(rng, n: int) -> list[tuple[int, int]]:
    """n (h, w) sizes: 1x1, odd widths, up to 640x480."""
    fixed = [(1, 1), (1, 7), (5, 1), (2, 3), (3, 3), (480, 640), (37, 41)]
    return (fixed + [(int(rng.integers(1, 120)), int(rng.integers(1, 120)))
                     for _ in range(n)])[:n]


def pil(a: np.ndarray) -> Image.Image:
    return Image.fromarray(a)


def same(want, got, what: str = "") -> None:
    want = np.asarray(want)
    assert want.shape == got.shape and want.dtype == got.dtype, what
    np.testing.assert_array_equal(got, want, err_msg=what)


def _factor(rng, i: int) -> float:
    """Factors below and above 1, the exact 0 and 1, and extrapolation."""
    fixed = [0.0, 1.0, 0.1, 1.9, -0.3, 2.5]
    return fixed[i] if i < len(fixed) else float(rng.uniform(-0.5, 2.5))


def _affine_matrix(rng) -> tuple:
    return (float(rng.uniform(0.7, 1.3)), float(rng.uniform(-0.4, 0.4)),
            float(rng.uniform(-30, 30)), float(rng.uniform(-0.4, 0.4)),
            float(rng.uniform(0.7, 1.3)), float(rng.uniform(-30, 30)))


def _case_resize(rng, a, i):
    H, W = a.shape[:2]
    w, h = int(rng.integers(1, 300)), int(rng.integers(1, 300))
    if i % 3 == 0:
        box = None
    elif i % 3 == 1:                           # an integer box, as RRC's
        x0, y0 = int(rng.integers(0, W)), int(rng.integers(0, H))
        box = (x0, y0, int(rng.integers(x0 + 1, W + 1)), int(rng.integers(y0 + 1, H + 1)))
    else:                                      # a float box
        x0, y0 = rng.uniform(0, W), rng.uniform(0, H)
        box = (x0, y0, rng.uniform(x0, W), rng.uniform(y0, H))
    return (pil(a).resize((w, h), Image.BICUBIC, box=box),
            pil_ops.resize_bicubic(a, (w, h), box))


def _case_affine(rng, a, i):
    m, fill = _affine_matrix(rng), tuple(int(v) for v in rng.integers(0, 256, 3))
    return (pil(a).transform(pil(a).size, Image.AFFINE, m, resample=Image.BILINEAR,
                             fillcolor=fill), pil_ops.affine_bilinear(a, m, fill))


def _case_rotate(rng, a, i):
    fixed = [0.0, 90.0, 180.0, 270.0, -90.0, 360.0, 30.0, -30.0]
    deg = fixed[i] if i < len(fixed) else float(rng.uniform(-45, 45))
    fill = tuple(int(v) for v in rng.integers(0, 256, 3))
    return (pil(a).rotate(deg, resample=Image.BILINEAR, fillcolor=fill),
            pil_ops.rotate_bilinear(a, deg, fill))


def _case_point(rng, a, i):
    """A table a band (768 entries), or one table for all (Pillow takes it
    repeated, as ImageOps' _lut passes it)."""
    lut = [int(v) for v in rng.integers(0, 256, 256 if i % 2 else 768)]
    return pil(a).point(lut * (3 if len(lut) == 256 else 1)), pil_ops.point(a, lut)


def _case_solarize(rng, a, i):
    t = int(rng.integers(0, 257))
    return ImageOps.solarize(pil(a), t), pil_ops.solarize(a, t)


def _case_posterize(rng, a, i):
    b = int(rng.integers(0, 8))
    return ImageOps.posterize(pil(a), b), pil_ops.posterize(a, b)


def _case_blend(rng, a, i):
    b, f = any_image(rng, *a.shape[:2]), _factor(rng, i)
    return Image.blend(pil(a), pil(b), f), pil_ops.blend(a, b, f)


def _enhance(cls, fn):
    def case(rng, a, i):
        f = _factor(rng, i)
        return cls(pil(a)).enhance(f), fn(a, f)
    return case


def _case_smooth(rng, a, i):
    return pil(a).filter(ImageFilter.SMOOTH), pil_ops.smooth(a)


PIL_OPS = {
    "resize_bicubic": _case_resize,
    "affine_bilinear": _case_affine,
    "rotate_bilinear": _case_rotate,
    "flip_lr": lambda rng, a, i: (pil(a).transpose(Image.FLIP_LEFT_RIGHT), pil_ops.flip_lr(a)),
    "point": _case_point,
    "autocontrast": lambda rng, a, i: (ImageOps.autocontrast(pil(a)), pil_ops.autocontrast(a)),
    "equalize": lambda rng, a, i: (ImageOps.equalize(pil(a)), pil_ops.equalize(a)),
    "invert": lambda rng, a, i: (ImageOps.invert(pil(a)), pil_ops.invert(a)),
    "solarize": _case_solarize,
    "posterize": _case_posterize,
    "blend": _case_blend,
    "enhance_color": _enhance(ImageEnhance.Color, pil_ops.enhance_color),
    "enhance_contrast": _enhance(ImageEnhance.Contrast, pil_ops.enhance_contrast),
    "enhance_brightness": _enhance(ImageEnhance.Brightness, pil_ops.enhance_brightness),
    "enhance_sharpness": _enhance(ImageEnhance.Sharpness, pil_ops.enhance_sharpness),
    "smooth": _case_smooth,
    "to_luma": lambda rng, a, i: (pil(a).convert("L"), pil_ops.to_luma(a)),
}
CASES, CHUNKS = 60, 3


@pytest.mark.parametrize("chunk", range(CHUNKS))
@pytest.mark.parametrize("op", sorted(PIL_OPS))
def test_pil_op_matches_pillow(op, chunk):
    """60 seeded cases an op (a third a chunk): 1x1, odd widths and up to
    640x480, fills, boxes, factors below and above 1; exact."""
    rng = np.random.default_rng(sorted(PIL_OPS).index(op) * 100 + chunk)
    per = CASES // CHUNKS
    for i, (h, w) in enumerate(sizes(rng, per)):
        a = any_image(rng, h, w)
        want, got = PIL_OPS[op](rng, a, chunk * per + i)
        same(want, got, f"{op} case {chunk * per + i} size {(h, w)}")


@pytest.mark.parametrize("mode,shape", [("L", (5, 7)), ("L", (6, 9, 1)), ("LA", (4, 3, 2)),
                                        ("RGBA", (3, 8, 4)), ("RGB", (2, 2, 3))])
def test_convert_rgb_matches_pillow(mode, shape):
    a = np.random.default_rng(sum(shape)).integers(0, 256, shape, dtype=np.uint8)
    same(Image.fromarray(a.reshape(shape[:2]) if mode == "L" else a, mode).convert("RGB"),
         pil_ops.convert_rgb(a))


def test_resize_rejects_a_box_outside_the_image():
    a = np.zeros((4, 5, 3), np.uint8)
    with pytest.raises(ValueError, match="box"):
        pil_ops.resize_bicubic(a, (3, 3), (0, 0, 6, 4))


# ---- auto_augment: every op and level map, the augmenters ----

HP = dict(translate_const=100, img_mean=(124, 116, 104))


def _state(rng) -> dict:
    return rng.bit_generator.state


@pytest.mark.parametrize("name", sorted(aa._OPS))
def test_augment_op_matches_jax(name):
    """AugmentOp at every magnitude mode (fixed, mstd, uniform mstd, mmax),
    probabilities below 1; pixels and the generator's state afterwards."""
    rng = np.random.default_rng(sorted(aa._OPS).index(name))
    hps = [HP, dict(HP, magnitude_std=0.5), dict(HP, magnitude_std=float("inf")),
           dict(HP, magnitude_std=0.5, magnitude_max=7)]
    for i in range(12):
        h, w = (int(rng.integers(8, 80)), int(rng.integers(8, 80)))
        a = any_image(rng, h, w)
        hp, prob, mag = hps[i % 4], [1.0, 0.5][i % 2], float(rng.integers(0, 11))
        seed = int(rng.integers(2 ** 31))
        rj, rp = np.random.default_rng(seed), np.random.default_rng(seed)
        want = jax_aa.AugmentOp(name, prob, mag, hp)(pil(a), rj)
        got = aa.AugmentOp(name, prob, mag, hp)(a, rp)
        same(want, got, f"{name} case {i}")
        assert _state(rj) == _state(rp), f"{name} case {i}: the generators diverge"


@pytest.mark.parametrize("name", sorted(aa._OPS))
def test_level_map_matches_jax(name):
    _, level_fn = aa._OPS[name]
    _, jax_level_fn = jax_aa._OPS[name]
    assert (level_fn is None) == (jax_level_fn is None)
    if level_fn is None:
        return
    for level in np.linspace(0, 10, 21):
        rj, rp = np.random.default_rng(int(level * 10)), np.random.default_rng(int(level * 10))
        assert level_fn(level, rp, HP) == jax_level_fn(level, rj, HP)
        assert _state(rj) == _state(rp)


@pytest.mark.parametrize("config", ["rand-m9-mstd0.5-inc1", "rand-m3-n2-mstd0.5",
                                    "rand-m7-n3-mstd101-mmax9", "original", "v0",
                                    "original-mstd0.5", "augmix-m5-w3", "augmix-m3-w2-d2-a0.5"])
def test_augmenter_matches_jax(config):
    """create_augmenter's RandAugment, AutoAugment and AugMix on seeded
    images and generators: the JAX module's pixels and generator state."""
    rng = np.random.default_rng(len(config))
    port, jax = aa.create_augmenter(config, HP), jax_aa.create_augmenter(config, HP)
    for i in range(10):
        a = any_image(rng, int(rng.integers(16, 96)), int(rng.integers(16, 96)))
        seed = int(rng.integers(2 ** 31))
        rj, rp = np.random.default_rng(seed), np.random.default_rng(seed)
        same(jax(pil(a), rj), port(a, rp), f"{config} case {i}")
        assert _state(rj) == _state(rp)


@pytest.mark.parametrize("mode,count", [("pixel", 1), ("rand", 1), ("const", 1), ("pixel", 3)])
def test_random_erasing_matches_jax(mode, count):
    rng = np.random.default_rng(count)
    for i in range(10):
        arr = rng.standard_normal((int(rng.integers(8, 240)), int(rng.integers(8, 240)), 3)
                                  ).astype(np.float32)
        seed = int(rng.integers(2 ** 31))
        rj, rp = np.random.default_rng(seed), np.random.default_rng(seed)
        want = jax_aa.RandomErasing(0.7, mode=mode, max_count=count)(arr.copy(), rj)
        got = aa.RandomErasing(0.7, mode=mode, max_count=count)(arr.copy(), rp)
        same(want, got, f"{mode} case {i}")
        assert _state(rj) == _state(rp)


@pytest.mark.parametrize("strength", [0.0, 0.4, 1.2])
def test_color_jitter_matches_jax(strength):
    rng = np.random.default_rng(int(strength * 10))
    for i in range(10):
        a = any_image(rng, int(rng.integers(4, 64)), int(rng.integers(4, 64)))
        seed = int(rng.integers(2 ** 31))
        rj, rp = np.random.default_rng(seed), np.random.default_rng(seed)
        same(jax_aa.color_jitter(pil(a), rj, strength), aa.color_jitter(a, rp, strength))
        assert _state(rj) == _state(rp)


# ---- det_aug: the whole train transform, the eval preprocessing ----

@pytest.mark.parametrize("wh", [(500, 375), (333, 500), (97, 61)])
def test_make_train_transform_matches_jax(wh):
    """TrainAugConfig() (RRC, flip, rand-m9-mstd0.5-inc1, random erasing)
    for 64 seeds on a source image: float32, bit for bit."""
    rng = np.random.default_rng(wh[0])
    a = field(rng, wh[1], wh[0])
    port = det_aug.make_train_transform(det_aug.TrainAugConfig())
    jax = jax_det_aug.make_train_transform(jax_det_aug.TrainAugConfig())
    for seed in range(64):
        same(jax(pil(a), seed), port(a, seed), f"seed {seed}")


@pytest.mark.parametrize("recipe", [
    dict(auto_augment="rand-m3-n2-mstd0.5"), dict(auto_augment=""),
    dict(auto_augment="original", reprob=0.0), dict(auto_augment="augmix-m3-w2"),
    dict(img_size=96, hflip=1.0, remode="rand", recount=2, color_jitter=0.0,
         auto_augment="", scale=(0.5, 1.0))])
def test_make_train_transform_recipes_match_jax(recipe):
    rng = np.random.default_rng(len(str(recipe)))
    port = det_aug.make_train_transform(det_aug.TrainAugConfig(**recipe))
    jax = jax_det_aug.make_train_transform(jax_det_aug.TrainAugConfig(**recipe))
    for seed in range(16):
        a = field(rng, int(rng.integers(20, 300)), int(rng.integers(20, 300)))
        same(jax(pil(a), seed), port(a, seed), f"seed {seed}")


@pytest.mark.parametrize("wh", [(500, 375), (375, 500), (31, 17)])
def test_train_transform_matches_jax(wh):
    a = field(np.random.default_rng(wh[1]), wh[1], wh[0])
    for seed in range(64):
        same(jax_det_aug.train_transform(pil(a), seed, 64),
             det_aug.train_transform(a, seed, 64), f"seed {seed}")


@pytest.mark.parametrize("wh,clip,crop", [((500, 375), False, True), ((333, 500), True, True),
                                          ((224, 224), False, False), ((61, 97), False, True),
                                          ((640, 480), True, False)])
def test_eval_preprocess_matches_jax(wh, clip, crop):
    a = field(np.random.default_rng(wh[0] * 7), wh[1], wh[0])
    for size in (224, 64, 37):
        cfg = transforms.eval_preprocess_config(size, crop=crop, clip=clip)
        jcfg = jax_transforms.eval_preprocess_config(size, crop=crop, clip=clip)
        same(jax_transforms.preprocess_pil(pil(a), jcfg), transforms.preprocess_pil(a, cfg))


# ---- the golden the card's host is held to ----

def golden_sources() -> list[np.ndarray]:
    rng = np.random.default_rng(2024)
    return [field(rng, h, w) for w, h in GOLDEN_SIZES]


def digest(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def golden_digests(transform_for, preprocess) -> dict:
    """{key: sha256 of the float32 output} for each recipe x source x seed
    ("recipe/source/seed") and the eval preprocessing of each source at 224
    ("eval/source"); `chip_smoke.phase_pixels` rebuilds them from the keys
    and the stored recipes."""
    out = {}
    for recipe, kw in GOLDEN_RECIPES.items():
        t = transform_for(kw)
        for i, src in enumerate(golden_sources()):
            for seed in GOLDEN_SEEDS:
                out[f"{recipe}/{i}/{seed}"] = digest(t(src, seed))
    for i, src in enumerate(golden_sources()):
        out[f"eval/{i}"] = digest(preprocess(src))
    return out


def jax_golden() -> dict:
    cfg = jax_transforms.eval_preprocess_config(224)
    return golden_digests(
        lambda kw: (lambda a, s, t=jax_det_aug.make_train_transform(
            jax_det_aug.TrainAugConfig(**kw)): t(pil(a), s)),
        lambda a: jax_transforms.preprocess_pil(pil(a), cfg))


def port_golden() -> dict:
    cfg = transforms.eval_preprocess_config(224)
    return golden_digests(
        lambda kw: det_aug.make_train_transform(det_aug.TrainAugConfig(**kw)),
        lambda a: transforms.preprocess_pil(a, cfg))


def test_golden_is_the_jax_packages_and_the_port_reproduces_it():
    g = np.load(GOLDEN)
    stored = dict(zip(g["keys"].tolist(), g["digests"].tolist()))
    assert json.loads(str(g["recipes"])) == GOLDEN_RECIPES
    for i, src in enumerate(golden_sources()):
        np.testing.assert_array_equal(g[f"source{i}"], src)
    assert port_golden() == stored
    assert jax_golden() == stored


# ---- the decoder ----

@pytest.mark.parametrize("mode,h,w", [("RGB", 5, 7), ("RGB", 1, 1), ("RGB", 33, 50),
                                      ("RGBA", 6, 3), ("RGBA", 17, 31)])
def test_bmp_reader_matches_pillow(tmp_path, mode, h, w):
    rng = np.random.default_rng(h * w)
    a = rng.integers(0, 256, (h, w, len(mode)), dtype=np.uint8)
    path = tmp_path / "x.bmp"
    Image.fromarray(a, mode).save(path)
    want = np.asarray(Image.open(path).convert("RGB"))
    same(want, image_io.read_rgb(str(path)))
    same(want, image_io.read_rgb(path.read_bytes()))
    assert image_io.decode_bmp(path.read_bytes()) is not None


def test_bmp_writer_round_trips_through_pillow(tmp_path):
    a = field(np.random.default_rng(3), 37, 61)
    image_io.write_bmp(tmp_path / "w.bmp", a)
    same(a, np.asarray(Image.open(tmp_path / "w.bmp").convert("RGB")))
    same(a, image_io.read_rgb(str(tmp_path / "w.bmp")))


@pytest.mark.parametrize("fmt,mode", [("PNG", "RGB"), ("PNG", "L"), ("PNG", "RGBA"),
                                      ("PNG", "P"), ("BMP", "L"), ("JPEG", "RGB")])
def test_read_rgb_other_formats_through_pillow(tmp_path, fmt, mode):
    a = field(np.random.default_rng(5), 9, 13)
    im = Image.fromarray(a).convert(mode)
    buf = io.BytesIO()
    im.save(buf, fmt)
    same(np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGB")),
         image_io.read_rgb(buf.getvalue()))


def test_read_rgb_without_pillow_raises_on_png(tmp_path, monkeypatch):
    a = field(np.random.default_rng(6), 8, 8)
    pil(a).save(tmp_path / "x.png")
    image_io.write_bmp(tmp_path / "x.bmp", a)
    real_import = builtins.__import__

    def no_pil(name, *args, **kw):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError(f"No module named {name!r}")
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(RuntimeError, match=r"x\.png.*Pillow"):
        image_io.read_rgb(str(tmp_path / "x.png"))
    same(a, image_io.read_rgb(str(tmp_path / "x.bmp")))     # BMP needs no Pillow


def test_port_and_smoke_import_no_pillow():
    """Every module of the port and chip_smoke.py import without Pillow
    (it is imported only where a non-BMP image is decoded)."""
    repo = Path(__file__).resolve().parent.parent
    code = ("import pkgutil, importlib, sys, cream_tpu_torch; "
            "[importlib.import_module(m.name) for m in pkgutil.walk_packages("
            "cream_tpu_torch.__path__, 'cream_tpu_torch.')]; import chip_smoke; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('PIL', 'jax', 'cream_tpu')]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(repo), os.environ.get("PYTHONPATH")) if p))
    subprocess.run([sys.executable, "-c", code], check=True, env=env, cwd=repo)


if __name__ == "__main__":
    GOLDEN.parent.mkdir(parents=True, exist_ok=True)
    digests = jax_golden()
    np.savez_compressed(GOLDEN, keys=np.asarray(list(digests)),
                        digests=np.asarray(list(digests.values())),
                        recipes=np.asarray(json.dumps(GOLDEN_RECIPES)),
                        **{f"source{i}": s for i, s in enumerate(golden_sources())})
    print(f"wrote {GOLDEN} ({len(digests)} outputs)")
