"""cream_tpu_torch's native image pipeline (`data/native_pipe.py` on its copy
of `native/image_pipe.cc`) and the loaders' native branches, against the
JAX package on the CPU.

The library is built here by g++ from the port's sources (never the JAX
package's `native/libimage_pipe.so`). Contract: the seeded decisions (eval
size math, RRC boxes, flip coins) equal JAX's rows integer for integer;
the pixels are within JAX's own tolerance of the exact path (fp32 against
Pillow's fixed point: mean |d| < 0.012, max < 0.40 in normalized units,
`tests/test_native_pipe.py`); an image the pipeline cannot decode (PNG,
truncated bytes) takes the exact path, bit for bit. The exact path on
JPEGs gives JAX's loaders' batches bit for bit. `native=True` raises where
the library does not build; "auto" then takes the exact path and says so.
JPEGs and PNGs are written by the tests with Pillow.
"""
import io
import logging

import numpy as np
import pytest
from PIL import Image

from cream_tpu.data import imagenet as jax_imagenet
from cream_tpu.data import native_pipe as jax_native_pipe
from cream_tpu.data.transforms import eval_preprocess_config as jax_eval_config
from cream_tpu_torch.data import imagenet, native_pipe, pil_ops
from cream_tpu_torch.data.det_aug import TrainAugConfig, make_train_transform, train_transform
from cream_tpu_torch.data.image_io import read_rgb
from cream_tpu_torch.data.transforms import eval_preprocess_config, preprocess_pil

MEAN_TOL = 0.012   # ~0.7 of a pixel level on average
MAX_TOL = 0.40     # isolated pixels on sharp edges
SIZES = [(500, 375), (640, 480), (224, 224), (150, 300)]
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


def jpeg(w, h, seed=0, q=92) -> bytes:
    """A smooth seeded JPEG (JAX's test image: a coarse random grid, bicubic
    upsampled)."""
    rng = np.random.default_rng(seed)
    small = rng.integers(0, 256, (max(2, h // 12), max(2, w // 12), 3), dtype=np.uint8)
    arr = np.asarray(Image.fromarray(small).resize((w, h), Image.BICUBIC))
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", quality=q)
    return buf.getvalue()


def png(w, h, seed=0) -> bytes:
    rng = np.random.default_rng(seed)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(buf, "PNG")
    return buf.getvalue()


def prescaled(row) -> bool:
    """Whether image_pipe.cc decodes a params row at a reduced DCT scale:
    the box is at least 12/7 of the resample size on both axes."""
    return row[2] * 7 >= 12 * row[4] and row[3] * 7 >= 12 * row[5]


def close(got, want, what=""):
    d = np.abs(got - want)
    assert d.mean() < MEAN_TOL and d.max() < MAX_TOL, (what, d.mean(), d.max())


@pytest.fixture(scope="module")
def lib():
    assert native_pipe.available(), "the port's native pipeline did not build"
    return native_pipe


def test_probe_sizes(lib):
    bufs = [jpeg(320, 200), b"not a jpeg", jpeg(64, 48), png(30, 20)]
    assert lib.probe_sizes(bufs).tolist() == [[320, 200], [0, 0], [64, 48], [0, 0]]


def test_decisions_equal_jax_rows():
    wh = np.asarray([(500, 375), (375, 500), (640, 480), (224, 224), (150, 300),
                     (333, 500), (0, 0), (17, 1000)], np.int32)
    for crop, clip, size in ((True, False, 224), (False, True, 160), (True, True, 96)):
        np.testing.assert_array_equal(
            native_pipe.eval_params(wh, eval_preprocess_config(size, crop=crop, clip=clip)),
            jax_native_pipe.eval_params(wh, jax_eval_config(size, crop=crop, clip=clip)))
    seeds = np.random.default_rng(0).integers(0, 2 ** 31 - 1, len(wh))
    for size, scale, hflip in ((224, (0.08, 1.0), 0.5), (128, (0.5, 0.9), 0.25)):
        np.testing.assert_array_equal(
            native_pipe.train_params(wh, seeds, size, scale=scale, hflip=hflip),
            jax_native_pipe.train_params(wh, seeds, size, scale=scale, hflip=hflip))


def test_eval_pixels_within_tolerance_of_the_exact_path(lib):
    cfg = eval_preprocess_config(224)
    bufs = [jpeg(w, h, i + 1) for i, (w, h) in enumerate(SIZES)]
    wh = lib.probe_sizes(bufs)
    imgs, status = lib.decode_batch(bufs, lib.eval_params(wh, cfg), 224, cfg.mean,
                                    cfg.std, allow_prescale=False)
    assert (status == 0).all() and imgs.shape == (4, 224, 224, 3)
    for i, b in enumerate(bufs):
        close(imgs[i], preprocess_pil(read_rgb(b), cfg), SIZES[i])


def test_train_pixels_within_tolerance(lib):
    bufs = [jpeg(w, h, 10 + i) for i, (w, h) in enumerate(SIZES)]
    wh = lib.probe_sizes(bufs)
    seeds = [123, 456, 789, 1011]
    params = lib.train_params(wh, seeds, 224)
    imgs, status = lib.decode_batch(bufs, params, 224, MEAN, STD, allow_prescale=False)
    assert (status == 0).all()
    for i, b in enumerate(bufs):
        # the same box and flip: a mismatch in either is O(1) everywhere
        close(imgs[i], train_transform(read_rgb(b), seeds[i], 224), SIZES[i])
    # with DCT prescaling allowed, a box under 12/7 of the output decodes at
    # full scale, bit for bit as without; (640, 480)'s 391 x 403 box decodes
    # at 7/8 (`test_prescaled_decode_against_pillows_draft` holds that route)
    pre, status = lib.decode_batch(bufs, params, 224, MEAN, STD, allow_prescale=True)
    assert (status == 0).all()
    assert [prescaled(r) for r in params] == [False, True, False, False]
    for i in range(len(bufs)):
        if prescaled(params[i]):
            assert not np.array_equal(pre[i], imgs[i])
        else:
            np.testing.assert_array_equal(pre[i], imgs[i])


def test_prescaled_decode_against_pillows_draft(lib):
    """A 340 x 320 box to 96 x 96 decodes at 4/8 (the largest s/8 whose box
    is still under 12/(s-1) of the output... i.e. the C++'s rule stops at
    s = 4); Pillow's `draft` decodes the same JPEG at 1/2 by libjpeg's
    scaled IDCT, and the exact path resamples the C++'s rounded box of it."""
    buf = jpeg(500, 375, 21)
    row = np.asarray([[20, 10, 340, 320, 96, 96, 0, 0, 1]], np.int32)
    got, status = lib.decode_batch([buf], row, 96, MEAN, STD, allow_prescale=True)
    full, _ = lib.decode_batch([buf], row, 96, MEAN, STD, allow_prescale=False)
    assert status[0] == 0 and not np.array_equal(got, full)
    im = Image.open(io.BytesIO(buf))
    im.draft("RGB", (250, 187))     # scale 1/2: 375 // 187 == 2
    small = np.asarray(im.convert("RGB"))
    assert small.shape == (188, 250, 3)
    # the C++'s box at scale 1/2: lround(x * 0.5), as (10, 5, 180, 165)
    ref = pil_ops.resize_bicubic(small, (96, 96), (10, 5, 180, 165))[:, ::-1]
    ref = (ref.astype(np.float32) / 255.0 - np.float32(MEAN)) / np.float32(STD)
    close(got[0], ref, "4/8")


def test_failure_status_for_png_and_truncated_bytes(lib):
    cfg = eval_preprocess_config(64)
    good = jpeg(120, 90, 3)
    bufs = [png(120, 90), good[:len(good) // 3], good]
    params = np.tile(np.asarray([[0, 0, 120, 90, 85, 73, 10, 4, 0]], np.int32), (3, 1))
    imgs, status = lib.decode_batch(bufs, params, 64, cfg.mean, cfg.std)
    assert status[0] != 0 and (imgs[0] == 0).all()
    assert status[2] == 0
    # a truncated JPEG either fails or decodes libjpeg's grey fill: the
    # loaders also route an unparseable header ((0, 0) size) to the exact path
    assert status[1] != 0 or lib.probe_sizes(bufs[1:2]).tolist() == [[120, 90]]


def make_jpeg_folder(root) -> None:
    """Two classes of seeded JPEGs at assorted sizes, and one PNG."""
    for c, (cls, seed) in enumerate((("n0001", 10), ("n0002", 20))):
        (root / cls).mkdir(parents=True)
        for k, (w, h) in enumerate(((300, 250), (250, 300), (256, 256))):
            (root / cls / f"img{k}.jpg").write_bytes(jpeg(w, h, seed + k, q=90))
    (root / "n0001" / "img9.png").write_bytes(png(120, 100, 7))


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("jpegs")
    make_jpeg_folder(root)
    return (imagenet.ImageFolder(str(root)), jax_imagenet.ImageFolder(str(root)),
            root / "n0001" / "img9.png")


def _batches_equal(got, want, keys):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for k in keys:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_native_eval_loader_against_jax(lib, folder):
    ds, jds, png_path = folder
    want = list(jax_imagenet.eval_loader(jds, 4, 64, num_workers=2))
    got = list(imagenet.eval_loader(ds, 4, 64, num_workers=2, native=True))
    _batches_equal(got, want, ("label", "index"))
    j = [p for p, _ in ds.samples].index(str(png_path))
    for g, w in zip(got, want):
        live = w["index"] >= 0
        for r in np.nonzero(live)[0]:
            if w["index"][r] == j:      # the PNG: the exact path, bit for bit
                np.testing.assert_array_equal(g["image"][r], w["image"][r])
            else:
                close(g["image"][r], w["image"][r], int(w["index"][r]))
        assert (g["image"][~live] == 0).all()


def test_native_train_loader_against_jax(lib, folder):
    """JAX's batches' labels, indices and seeds; each JPEG the pipeline's
    decode of JAX's decision row (`train_params` of JAX's seeds), DCT
    prescaling allowed; where a row does not prescale, within the tolerance
    of JAX's exact pixels (a prescaled decode's pixels are held to Pillow's
    scaled decode by `test_prescaled_decode_against_pillows_draft`); the
    PNG, JAX's exact pixels bit for bit."""
    ds, jds, png_path = folder
    want = list(jax_imagenet.train_loader(jds, 3, epoch=1, base_seed=5, img_size=96,
                                          num_workers=2))
    got = list(imagenet.train_loader(ds, 3, epoch=1, base_seed=5, img_size=96,
                                     num_workers=2, native=True))
    _batches_equal(got, want, ("label", "index", "seed"))
    j = [p for p, _ in ds.samples].index(str(png_path))
    kinds = set()
    for g, w in zip(got, want):
        for r, i in enumerate(w["index"]):
            if i == j:
                np.testing.assert_array_equal(g["image"][r], w["image"][r])
                kinds.add("png")
                continue
            buf = ds.load_bytes(int(i))[0]
            row = jax_native_pipe.train_params(lib.probe_sizes([buf]), w["seed"][r:r + 1], 96)
            one, _ = lib.decode_batch([buf], row, 96, MEAN, STD, allow_prescale=True)
            np.testing.assert_array_equal(g["image"][r], one[0])
            if not prescaled(row[0]):
                close(g["image"][r], w["image"][r], int(i))
            kinds.add(prescaled(row[0]))
    assert kinds == {"png", True, False}


def test_exact_path_on_jpegs_equals_jax(folder):
    ds, jds, _ = folder
    _batches_equal(list(imagenet.eval_loader(ds, 4, 64, num_workers=1)),
                   list(jax_imagenet.eval_loader(jds, 4, 64, num_workers=2)),
                   ("image", "label", "index"))
    _batches_equal(list(imagenet.train_loader(ds, 3, epoch=2, img_size=96, num_workers=2)),
                   list(jax_imagenet.train_loader(jds, 3, epoch=2, img_size=96,
                                                  num_workers=2)),
                   ("image", "label", "index", "seed"))


@pytest.fixture
def broken_compiler(monkeypatch, tmp_path):
    """A g++ that does not exist, and a build directory of the test's own."""
    monkeypatch.setattr(native_pipe, "CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(native_pipe, "BUILD_DIR", tmp_path / "build")


def test_native_true_raises_when_the_build_fails(folder, broken_compiler):
    ds, _, _ = folder
    assert not native_pipe.available()
    with pytest.raises(RuntimeError, match="no-such-g\\+\\+"):
        next(imagenet.eval_loader(ds, 4, 64, num_workers=1, native=True))
    with pytest.raises(RuntimeError, match="building the native image pipeline failed"):
        next(imagenet.train_loader(ds, 3, epoch=0, img_size=64, num_workers=1, native=True))


def test_auto_takes_the_exact_path_and_says_so(folder, broken_compiler, caplog):
    ds, jds, _ = folder
    with caplog.at_level(logging.INFO, logger=native_pipe.__name__):
        got = list(imagenet.eval_loader(ds, 4, 64, num_workers=1, native="auto"))
    said = [r for r in caplog.records if r.name == native_pipe.__name__]
    assert len(said) == 1 and "exact" in said[0].getMessage()
    _batches_equal(got, list(jax_imagenet.eval_loader(jds, 4, 64, num_workers=2)),
                   ("image", "label", "index"))


def test_auto_takes_the_native_path_where_it_builds(lib, folder, caplog):
    ds, _, _ = folder
    with caplog.at_level(logging.INFO, logger=native_pipe.__name__):
        auto = list(imagenet.eval_loader(ds, 4, 64, num_workers=1, native="auto"))
    assert "native image pipeline" in caplog.text
    _batches_equal(auto, list(imagenet.eval_loader(ds, 4, 64, num_workers=1, native=True)),
                   ("image", "label", "index"))


def test_native_refusals(folder):
    ds, _, _ = folder
    with pytest.raises(ValueError, match="RRC"):
        next(imagenet.train_loader(ds, 3, epoch=0, native=True,
                                   transform=make_train_transform(TrainAugConfig())))
    with pytest.raises(RuntimeError, match="load_bytes"):
        next(imagenet.eval_loader(imagenet.SyntheticDataset(4, 32), 4, 32, native=True))
    with pytest.raises(ValueError, match="native"):
        next(imagenet.eval_loader(ds, 4, 64, native="yes"))
