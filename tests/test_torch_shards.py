"""cream_tpu_torch's image-text tar-shard reader (`data/shards.py`) against
the JAX package's `cream_tpu.data.shards`, on the CPU.

Shards written here with Pillow (JPEG members, a PNG member, a json
member, a member without a caption): the pairs and the detshuffle2 order
for two epochs, `start_sample` resume; `image_text_loader`'s exact path
against JAX's bit for bit, its tokens through one stub tokenizer shared by
both, `start_batch` the tail of the full epoch; the native path within JAX's
tolerance of the exact path (the PNG member bit for bit); `CsvDataset`'s
rows and pixels.
"""
import io
import tarfile

import numpy as np
import pytest
from PIL import Image

from cream_tpu.data import shards as jax_shards
from cream_tpu_torch.data import native_pipe, shards

MEAN_TOL, MAX_TOL = 0.012, 0.40


def _jpeg(w, h, seed, q=90) -> bytes:
    rng = np.random.default_rng(seed)
    small = rng.integers(0, 256, (max(2, h // 12), max(2, w // 12), 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(np.asarray(Image.fromarray(small).resize((w, h), Image.BICUBIC))).save(
        buf, "JPEG", quality=q)
    return buf.getvalue()


def _png(w, h, seed) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)
                    ).save(buf, "PNG")
    return buf.getvalue()


def _add(tf, name, payload: bytes):
    info = tarfile.TarInfo(name)
    info.size = len(payload)
    tf.addfile(info, io.BytesIO(payload))


def write_shards(root, n_shards=3, per=5) -> list[str]:
    """Seeded shards of (key.jpg, key.txt) pairs; shard 0's pair 2 a PNG,
    shard 1 a json member and an image without a caption."""
    paths = []
    for s in range(n_shards):
        path = root / f"shard-{s:03d}.tar"
        with tarfile.open(path, "w") as tf:
            for k in range(per):
                key = f"s{s}_{k:03d}"
                w, h = (96, 72) if (s + k) % 2 else (72, 96)
                if (s, k) == (0, 2):
                    _add(tf, f"{key}.png", _png(w, h, 100 * s + k))
                else:
                    _add(tf, f"{key}.jpg", _jpeg(w, h, 100 * s + k))
                if (s, k) == (1, 1):
                    _add(tf, f"{key}.json", b'{"note": 1}')
                _add(tf, f"{key}.txt", f"  a photo number {s} {k} \xe9 ".encode("latin-1"))
            if s == 1:
                _add(tf, "orphan.jpg", _jpeg(40, 40, 999))
        paths.append(str(path))
    return paths


@pytest.fixture(scope="module")
def shard_paths(tmp_path_factory):
    return write_shards(tmp_path_factory.mktemp("shards"))


def stub_tokenizer(texts, context_length):
    """Shared by both packages: the text's first bytes as ids."""
    out = np.zeros((len(texts), context_length), np.int32)
    for i, t in enumerate(texts):
        b = t.encode("utf-8")[:context_length]
        out[i, :len(b)] = list(b)
    return out


def test_pairs_and_epoch_order_match_jax(shard_paths):
    for p in shard_paths:
        assert list(shards.iter_tar_pairs(p)) == list(jax_shards.iter_tar_pairs(p))
    ds, jds = shards.ShardListDataset(shard_paths, seed=3), jax_shards.ShardListDataset(
        shard_paths, seed=3)
    orders = []
    for epoch in (0, 1):
        got = [k for k, _, _ in ds.epoch_iter(epoch)]
        assert got == [k for k, _, _ in jds.epoch_iter(epoch)] and len(got) == 15
        orders.append(got)
        tail = [k for k, _, _ in ds.epoch_iter(epoch, start_sample=7)]
        assert tail == got[7:] == [k for k, _, _ in jds.epoch_iter(epoch, start_sample=7)]
    assert orders[0] != orders[1]          # the shard order is a function of the epoch


def test_exact_loader_matches_jax_bit_for_bit(shard_paths):
    ds, jds = shards.ShardListDataset(shard_paths, seed=1), jax_shards.ShardListDataset(
        shard_paths, seed=1)
    kw = dict(epoch=2, batch_size=4, img_size=64, context_length=16)
    got = list(shards.image_text_loader(ds, stub_tokenizer, num_workers=2, **kw))
    want = list(jax_shards.image_text_loader(jds, stub_tokenizer, num_workers=2, **kw))
    assert len(got) == len(want) == 3          # 15 pairs, the partial batch dropped
    for g, w in zip(got, want):
        assert g["image"].dtype == w["image"].dtype == np.float32
        np.testing.assert_array_equal(g["image"], w["image"])
        np.testing.assert_array_equal(g["text"], w["text"])
    resumed = list(shards.image_text_loader(ds, stub_tokenizer, num_workers=1,
                                            start_batch=1, **kw))
    assert len(resumed) == 2
    for g, w in zip(resumed, got[1:]):
        np.testing.assert_array_equal(g["image"], w["image"])
        np.testing.assert_array_equal(g["text"], w["text"])


def test_native_loader_within_tolerance(shard_paths):
    assert native_pipe.available()
    ds = shards.ShardListDataset(shard_paths, seed=1)
    kw = dict(epoch=0, batch_size=5, img_size=64, context_length=16)
    exact = list(shards.image_text_loader(ds, stub_tokenizer, num_workers=1, **kw))
    native = list(shards.image_text_loader(ds, stub_tokenizer, num_workers=2, native=True,
                                           **kw))
    keys = [k for k, _, _ in ds.epoch_iter(0)]
    assert len(native) == len(exact) == 3
    for b, (g, w) in enumerate(zip(native, exact)):
        np.testing.assert_array_equal(g["text"], w["text"])
        for r in range(5):
            if keys[5 * b + r] == "s0_002":       # the PNG: the exact path's pixels
                np.testing.assert_array_equal(g["image"][r], w["image"][r])
            else:
                d = np.abs(g["image"][r] - w["image"][r])
                assert d.mean() < MEAN_TOL and d.max() < MAX_TOL, (b, r, d.mean(), d.max())


def test_csv_dataset_matches_jax(tmp_path):
    rows = []
    for i in range(3):
        name = f"img{i}.jpg" if i != 1 else "img1.png"
        (tmp_path / name).write_bytes(_jpeg(50 + 10 * i, 40, i) if i != 1 else _png(30, 20, i))
        rows.append(f"{name}\tcaption {i}")
    rows.append("a line without a caption")
    (tmp_path / "pairs.csv").write_text("\n".join(rows) + "\n")
    ds = shards.CsvDataset(str(tmp_path / "pairs.csv"))
    jds = jax_shards.CsvDataset(str(tmp_path / "pairs.csv"))
    assert ds.rows == jds.rows and len(ds) == len(jds) == 3
    for i in range(len(ds)):
        img, cap = ds.load(i)
        jimg, jcap = jds.load(i)
        assert cap == jcap and img.dtype == np.uint8
        np.testing.assert_array_equal(img, np.asarray(jimg.convert("RGB")))
