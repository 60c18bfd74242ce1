"""cream_tpu_torch's image-folder datasets, loaders and CLIs against the JAX
package's, on the CPU.

Folders of seeded BMP and PNG files in `tmp_path`: the datasets' listings
and pixels, `eval_loader` / `train_loader` batches (`image`, `label`,
`index`, `seed`) against JAX's, exactly, with repeated augmentation, host
sharding and padding, and on the synthetic set; `sub_imagenet`'s
membership; `cli.eval` against `cream_tpu.cli.eval` (acc@1, acc@5, n);
`cli.train`'s first batch and loss on a folder against JAX's loader and
`make_train_step`; `--evo-subset` and zero-shot on a folder; TinyViT's
`remat_stem` against the run without it.
"""
import zipfile

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from cream_tpu.data import imagenet as jax_imagenet
from cream_tpu_torch.data import imagenet
from cream_tpu_torch.data.image_io import write_bmp
from cream_tpu_torch.models.tinyvit import TinyViT
from cream_tpu_torch.zoo.load import seeded_state_dict
from test_torch_data_aug import field
from torch_threads import one_torch_thread_module  # noqa: F401

CLASSES = ("n01440764", "n01443537", "n01484850")


def make_folder(root, per_class=(4, 3, 5), seed=0, png_every=3) -> list:
    """Class folders of seeded images of assorted sizes; every
    `png_every`-th file a PNG (Pillow-decoded), the rest BMP (numpy)."""
    rng = np.random.default_rng(seed)
    paths = []
    for c, n in zip(CLASSES, per_class):
        (root / c).mkdir(parents=True)
        for i in range(n):
            h, w = int(rng.integers(20, 90)), int(rng.integers(20, 90))
            a = field(rng, h, w)
            path = root / c / f"img_{i:03d}.{'png' if i % png_every == 2 else 'bmp'}"
            if path.suffix == ".png":
                Image.fromarray(a).save(path)
            else:
                write_bmp(path, a)
            paths.append(path)
    (root / CLASSES[0] / "notes.txt").write_text("not an image")
    return paths


@pytest.fixture
def folder(tmp_path):
    make_folder(tmp_path / "train", (7, 6, 8), seed=0)
    make_folder(tmp_path / "val", (4, 3, 4), seed=1)
    return tmp_path


def _same_batches(got, want, keys):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for k in keys:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_image_folder_lists_and_decodes_as_jax(folder):
    ds, jds = imagenet.ImageFolder(str(folder / "train")), jax_imagenet.ImageFolder(
        str(folder / "train"))
    assert ds.samples == jds.samples and ds.class_to_idx == jds.class_to_idx
    for i in range(len(ds)):
        img, label = ds.load(i)
        jimg, jlabel = jds.load(i)
        np.testing.assert_array_equal(img, np.asarray(jimg.convert("RGB")))
        assert label == jlabel and ds.load_bytes(i) == jds.load_bytes(i)


def _zip_folder(src, dst):
    with zipfile.ZipFile(dst, "w") as zf:
        for p in sorted(src.rglob("*")):
            if p.is_file():
                zf.write(p, p.relative_to(src).as_posix())


def test_zip_and_in22k_datasets_match_jax(folder, tmp_path):
    _zip_folder(folder / "val", tmp_path / "val.zip")
    ds, jds = (imagenet.ZipImageFolder(str(tmp_path / "val.zip")),
               jax_imagenet.ZipImageFolder(str(tmp_path / "val.zip")))
    assert ds.samples == jds.samples and ds.class_to_idx == jds.class_to_idx
    for i in range(len(ds)):
        np.testing.assert_array_equal(ds.load(i)[0], np.asarray(jds.load(i)[0].convert("RGB")))
        assert ds.load_bytes(i) == jds.load_bytes(i)
    # TinyViT's 22k layout: one zip a class, members {id}.jpeg, an id list
    root = tmp_path / "in22k"
    root.mkdir()
    rng = np.random.default_rng(3)
    names = []
    for c in ("n00004475", "n00001740"):
        with zipfile.ZipFile(root / f"{c}.zip", "w") as zf:
            for i in range(3):
                buf = root / "tmp.bmp"
                write_bmp(buf, field(rng, 17 + i, 23))
                zf.write(buf, f"{c}_{i}.jpeg")
                names.append(f"{c}_{i}")
        (root / "tmp.bmp").unlink()
    (root / "in22k_image_names.txt").write_text("\n".join(names) + "\n")
    ds, jds = imagenet.IN22KDataset(str(root)), jax_imagenet.IN22KDataset(str(root))
    assert ds.samples == jds.samples and ds.get_keys() == jds.get_keys()
    assert ds.nb_classes == jds.nb_classes == 2
    for i in range(len(ds)):
        np.testing.assert_array_equal(ds.load(i)[0], np.asarray(jds.load(i)[0].convert("RGB")))
        assert ds.load(i)[1] == jds.load(i)[1] and ds.load_bytes(i) == jds.load_bytes(i)


@pytest.mark.parametrize("per_class", [2, 3, 10])
def test_sub_imagenet_membership_matches_jax(folder, per_class):
    ds = imagenet.sub_imagenet(imagenet.ImageFolder(str(folder / "train")), per_class)
    jds = jax_imagenet.sub_imagenet(jax_imagenet.ImageFolder(str(folder / "train")), per_class)
    assert ds.samples == jds.samples
    assert len(ds.samples) == sum(min(per_class, n) for n in (7, 6, 8))


@pytest.mark.parametrize("kw", [
    dict(), dict(crop=False), dict(clip_norm=True), dict(pad_final=False),
    dict(shard=(0, 2)), dict(shard=(1, 2)), dict(shard=(2, 3)), dict(img_size=48)])
def test_eval_loader_matches_jax(folder, kw):
    kw = {"img_size": 32, **kw}
    ds = imagenet.ImageFolder(str(folder / "val"))
    jds = jax_imagenet.ImageFolder(str(folder / "val"))
    _same_batches(imagenet.eval_loader(ds, 4, num_workers=2, **kw),
                  jax_imagenet.eval_loader(jds, 4, num_workers=2, **kw),
                  ("image", "label", "index"))


def test_eval_loader_shards_run_the_same_steps(folder):
    ds = imagenet.ImageFolder(str(folder / "val"))          # 11 images
    steps = [sum(1 for _ in imagenet.eval_loader(ds, 2, 16, shard=(s, 3), num_workers=1))
             for s in range(3)]
    assert steps == [2, 2, 2]


@pytest.mark.parametrize("kw", [
    dict(), dict(repeated_aug=3), dict(shard=(0, 2)), dict(shard=(2, 3), repeated_aug=2),
    dict(shuffle=False, drop_last=False), dict(epoch=4, base_seed=9)])
def test_train_loader_matches_jax(folder, kw):
    """The default seeded RRC + flip at 32 px."""
    kw = {"epoch": 1, "base_seed": 0, **kw}
    ds = imagenet.ImageFolder(str(folder / "train"))
    jds = jax_imagenet.ImageFolder(str(folder / "train"))
    _same_batches(imagenet.train_loader(ds, 4, img_size=32, num_workers=2, **kw),
                  jax_imagenet.train_loader(jds, 4, img_size=32, num_workers=2, **kw),
                  ("image", "label", "index", "seed"))


def test_train_loader_full_recipe_matches_jax(folder):
    from cream_tpu.data.det_aug import TrainAugConfig as JaxAug
    from cream_tpu.data.det_aug import make_train_transform as jax_transform
    from cream_tpu_torch.data.det_aug import TrainAugConfig, make_train_transform
    ds = imagenet.ImageFolder(str(folder / "train"))
    jds = jax_imagenet.ImageFolder(str(folder / "train"))
    _same_batches(imagenet.train_loader(
        ds, 5, 2, 3, 48, 2, transform=make_train_transform(TrainAugConfig(img_size=48)),
        repeated_aug=2),
        jax_imagenet.train_loader(
            jds, 5, 2, 3, 48, 2, transform=jax_transform(JaxAug(img_size=48)), repeated_aug=2),
        ("image", "label", "index", "seed"))


def test_synthetic_set_loaders_match_jax():
    ds = imagenet.SyntheticDataset(10, 40, 7)
    jds = jax_imagenet.SyntheticDataset(10, 40, 7)
    _same_batches(imagenet.train_loader(ds, 3, 2, 1, 40, 2),
                  jax_imagenet.train_loader(jds, 3, 2, 1, 40, 2),
                  ("image", "label", "index", "seed"))
    _same_batches(imagenet.eval_loader(ds, 4, 40, num_workers=2),
                  jax_imagenet.eval_loader(jds, 4, 40, num_workers=2),
                  ("image", "label", "index"))


def test_native_option():
    """A dataset without `load_bytes` (the synthetic set): "auto" takes the
    exact path, True raises, as the JAX loaders do (the native pipeline
    itself: tests/test_torch_native_pipe.py)."""
    ds = imagenet.SyntheticDataset(4, 16, 2)
    _same_batches(imagenet.eval_loader(ds, 2, 16, native="auto"),
                  imagenet.eval_loader(ds, 2, 16), ("image", "label", "index"))
    for loader in (lambda: imagenet.eval_loader(ds, 2, 16, native=True),
                   lambda: imagenet.train_loader(ds, 2, 0, native=True)):
        with pytest.raises(RuntimeError, match="load_bytes"):
            next(iter(loader()))


def test_worker_functions_pickle(folder, tmp_path):
    """The loaders pickle their dataset and transform to the workers: the
    recipe pickles as its config and rebuilds the same function, and a zip
    folder whose reader has a handle open pickles as its path."""
    import pickle

    from cream_tpu_torch.data.det_aug import TrainAugConfig, make_train_transform
    recipe = make_train_transform(TrainAugConfig(img_size=32))
    back = pickle.loads(pickle.dumps(recipe))
    img = imagenet.ImageFolder(str(folder / "train")).load(0)[0]
    for seed in range(8):
        np.testing.assert_array_equal(back(img, seed), recipe(img, seed))
    _zip_folder(folder / "val", tmp_path / "val.zip")
    zds = imagenet.ZipImageFolder(str(tmp_path / "val.zip"))
    first = zds.load(0)[0]
    zback = pickle.loads(pickle.dumps(zds))
    assert zback.samples == zds.samples
    np.testing.assert_array_equal(zback.load(0)[0], first)


def test_loader_workers_come_from_the_fork_server(folder, tmp_path):
    """No worker is forked from this multithreaded process: the pool's
    start method is the fork server's, and with a live thread here and
    DeprecationWarning (Python's warning on a fork with threads) an error,
    a zip folder's eval batches and the full recipe's train batches through
    `prefetch` equal the one-process loaders'."""
    import threading
    import warnings

    from cream_tpu_torch.data.det_aug import TrainAugConfig, make_train_transform
    _zip_folder(folder / "val", tmp_path / "val.zip")
    zds = imagenet.ZipImageFolder(str(tmp_path / "val.zip"))
    ds = imagenet.ImageFolder(str(folder / "train"))
    recipe = make_train_transform(TrainAugConfig(img_size=32))
    stop = threading.Event()
    threading.Thread(target=stop.wait, daemon=True).start()
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("error", DeprecationWarning)
            with imagenet.Workers(len, 2) as pool:
                assert pool.pool._mp_context.get_start_method() == "forkserver"
            _same_batches(imagenet.eval_loader(zds, 4, 32, num_workers=2),
                          imagenet.eval_loader(zds, 4, 32, num_workers=1),
                          ("image", "label", "index"))
            _same_batches(imagenet.prefetch(imagenet.train_loader(
                ds, 5, 0, 0, 32, 3, transform=recipe)),
                imagenet.train_loader(ds, 5, 0, 0, 32, 1, transform=recipe),
                ("image", "label", "index", "seed"))
    finally:
        stop.set()

# ---- the CLIs on a folder ----

# a narrow TinyViT at the released depths, which the JAX loader's converter
# assumes for every tiny_vit name
EVAL_NARROW = dict(embed_dims=(16, 16, 32, 32), depths=(2, 2, 6, 2), num_heads=(1, 1, 2, 2),
                   window_sizes=(7, 7, 14, 7))


def test_eval_cli_matches_jax(folder, tmp_path, capsys, monkeypatch):
    """A narrow TinyViT in fp32 at 64 px, registered on both sides, the
    port's seeded weights through --torch-ckpt on both: the same acc@1,
    acc@5 and n."""
    from cream_tpu.cli import eval as jax_eval
    from cream_tpu.models import registry as jax_registry
    from cream_tpu.models.tinyvit import TinyViT as JaxTinyViT
    from cream_tpu_torch.cli import eval as port_eval
    from cream_tpu_torch.models import registry

    def narrow(num_classes=1000, img_size=224, *, device, dtype=torch.float32):
        return TinyViT(img_size=img_size, num_classes=num_classes, drop_path_rate=0.0,
                       dtype=dtype, device=device, **EVAL_NARROW)

    def jax_narrow(num_classes=1000, dtype=None, **kw):
        return JaxTinyViT(num_classes=num_classes, drop_path_rate=0.0, **EVAL_NARROW)
    monkeypatch.setitem(registry._REGISTRY, "tiny_vit_narrow", narrow)
    monkeypatch.setitem(jax_registry._REGISTRY, "tiny_vit_narrow", jax_narrow)
    m = narrow(10, 64, device="cpu")
    torch.save(seeded_state_dict(m, 3), tmp_path / "w.pth")
    opts = ["model.name=tiny_vit_narrow", "model.num_classes=10", "model.dtype=float32",
            "data.dataset=imagenet", f"data.data_path={folder}", "data.img_size=64",
            "data.batch_size=8", "data.num_workers=2", "--torch-ckpt", str(tmp_path / "w.pth")]
    got = port_eval.main(["--device", "cpu", *opts])
    out = capsys.readouterr().out
    want = jax_eval.main(opts)
    assert got["n"] == want["n"] == 11
    assert (got["acc1"], got["acc5"]) == (want["acc1"], want["acc5"])
    assert f"acc@1={got['acc1']:.3f} acc@5={got['acc5']:.3f} n=11" in out


NARROW = dict(embed_dims=(16, 16, 32, 32), depths=(1, 2, 1, 1), num_heads=(1, 1, 2, 2),
              window_sizes=(7, 7, 14, 7))


def test_train_cli_first_batch_and_loss_match_jax(folder, tmp_path, monkeypatch):
    """One step of cli.train on the folder (mixup and cutmix off) with a
    narrow TinyViT: the batch the trainer takes is the JAX loader's with the
    JAX trainer's recipe, and its loss is JAX make_train_step's on that
    batch with the same weights (1e-4)."""
    import optax

    from cream_tpu.cli.train import build_train_transform as jax_recipe
    from cream_tpu.core.config import Config as JaxConfig
    from cream_tpu.models.tinyvit import TinyViT as JaxTinyViT
    from cream_tpu.train import TrainState as JaxTrainState
    from cream_tpu.train import make_train_step as jax_make_train_step
    from cream_tpu.train.losses import soft_target_ce as jax_ce
    from cream_tpu.zoo.import_torch import convert_tinyvit
    from cream_tpu_torch.cli import train
    from cream_tpu_torch.core.config import Config
    from cream_tpu_torch.models import registry

    def narrow_tinyvit(num_classes=1000, img_size=224, *, device, dtype=torch.float32):
        return TinyViT(img_size=img_size, num_classes=num_classes, drop_path_rate=0.0,
                       dtype=dtype, device=device, **NARROW)
    monkeypatch.setitem(registry._REGISTRY, "tiny_vit_narrow", narrow_tinyvit)
    (folder / "one").mkdir()
    make_folder(folder / "one" / "train", (2, 1, 2), seed=5)      # 5 images: one bs4 step
    make_folder(folder / "one" / "val", (1, 1, 1), seed=6)
    opts = ["model.name=tiny_vit_narrow", "model.num_classes=3", "model.img_size=64",
            "model.dtype=float32", "data.dataset=imagenet",
            f"data.data_path={folder / 'one'}", "data.img_size=64", "data.batch_size=4",
            "data.num_workers=2", "aug.mixup=0", "aug.cutmix=0", "train.epochs=1",
            "train.warmup_epochs=0", "train.seed=4", f"output={tmp_path / 'out'}"]
    seen, weights = {}, {}
    real_loader, real_step = train.train_loader, train.make_train_step

    def loader(*a, **kw):
        for b in real_loader(*a, **kw):
            seen.setdefault("batch", b)
            yield b

    def make_step(**kw):
        step = real_step(**kw)

        def wrapped(state, batch, seed):
            weights.setdefault("sd", {k: v.detach().clone()
                                      for k, v in state.model.state_dict().items()})
            state, metrics = step(state, batch, seed)
            seen.setdefault("loss", float(metrics["loss"]))
            return state, metrics
        return wrapped

    monkeypatch.setattr(train, "train_loader", loader)
    monkeypatch.setattr(train, "make_train_step", make_step)
    train.main(["--device", "cpu", *opts])
    cfg = Config.from_yaml(None, opts)
    jcfg = JaxConfig.from_yaml(None, [o for o in opts if not o.startswith("model.img_size")])
    want = next(iter(jax_imagenet.train_loader(
        jax_imagenet.ImageFolder(str(folder / "one" / "train")), 4, 0, cfg.train.seed,
        64, 2, transform=jax_recipe(jcfg))))
    for k in ("image", "label", "index", "seed"):
        np.testing.assert_array_equal(seen["batch"][k], want[k], err_msg=k)

    jm = JaxTinyViT(num_classes=3, drop_path_rate=0.0, **NARROW)
    variables = convert_tinyvit({k: v.numpy() for k, v in weights["sd"].items()},
                                depths=NARROW["depths"])
    state = JaxTrainState.create(params=variables["params"], tx=optax.sgd(0.0),
                                 batch_stats=variables["batch_stats"])
    step = jax_make_train_step(jm, loss_fn=jax_ce, donate=False)
    _, metrics = step(state, {"image": jax.numpy.asarray(want["image"]),
                              "label": jax.nn.one_hot(want["label"], 3)}, jax.random.key(0))
    assert abs(seen["loss"] - float(metrics["loss"])) <= 1e-4


def test_evo_subset_picks_jax_images(folder, tmp_path, monkeypatch):
    """search_evolution --evo-subset 2 on a folder: the candidates are
    scored on sub_imagenet's images, JAX's, resized and cropped as JAX's
    eval loader does."""
    from cream_tpu_torch.cli import search_evolution
    seen = []
    real = search_evolution.eval_loader

    def loader(ds, *a, **kw):
        seen.append(ds)
        return real(ds, *a, **kw)

    monkeypatch.setattr(search_evolution, "eval_loader", loader)
    search_evolution.main([
        "--device", "cpu", "--space", "tiny", "--allow-random", "--population", "2",
        "--epochs", "1", "--max-eval-batches", "2", "--evo-subset", "2",
        "--out", str(tmp_path / "evo.json"), "model.dtype=float32", "model.num_classes=3",
        "model.img_size=32", "data.img_size=32", "data.dataset=imagenet",
        f"data.data_path={folder}", "data.batch_size=4", "data.num_workers=2"])
    jsub = jax_imagenet.sub_imagenet(jax_imagenet.ImageFolder(str(folder / "val")), 2)
    (ds,) = seen
    assert ds.samples == jsub.samples and len(ds) == 6
    _same_batches(real(ds, 4, 32, True, num_workers=2),
                  jax_imagenet.eval_loader(jsub, 4, 32, True, num_workers=2),
                  ("image", "label", "index"))


def test_zero_shot_reads_a_folder_as_jax(folder, tmp_path, monkeypatch):
    """cli.zero_shot on a folder: its batches are JAX's eval loader's at
    the model's size with CLIP's normalisation."""
    from cream_tpu_torch.cli import zero_shot
    from cream_tpu_torch.data.tokenizer import learn_merges, write_merges
    names = ["goldfish", "tabby cat", "fire truck"]
    merges = tmp_path / "merges.txt.gz"
    write_merges(str(merges), learn_merges(names * 4, 200))
    (tmp_path / "names.txt").write_text("\n".join(names) + "\n")
    seen = []
    real = zero_shot.eval_loader

    def loader(*a, **kw):
        for b in real(*a, **kw):
            seen.append(b)
            yield b

    monkeypatch.setattr(zero_shot, "eval_loader", loader)
    res = zero_shot.main([
        "--device", "cpu", "--bpe", str(merges), "--classnames", str(tmp_path / "names.txt"),
        "model.name=tinyclip_vit_8m_16_text_3m", "model.dtype=float32",
        'model.extra={"img_size": 64}', "data.dataset=imagenet", f"data.data_path={folder}",
        "data.batch_size=4", "data.num_workers=2"])
    assert res["n"] == 11
    want = jax_imagenet.eval_loader(jax_imagenet.ImageFolder(str(folder / "val")), 4, 64,
                                    crop=True, clip_norm=True)
    _same_batches(seen, want, ("image", "label", "index"))


# ---- remat_stem ----

@pytest.mark.parametrize("drop_path", [0.0, 0.3])
def test_remat_stem_equals_the_run_without(drop_path):
    """A narrow TinyViT's train-mode loss, grads, BN statistics and
    generator state with remat_stem equal those without it, bit for bit."""
    narrow = dict(embed_dims=(16, 16, 32, 32), depths=(2, 1, 1, 1), num_heads=(1, 1, 2, 2),
                  window_sizes=(7, 7, 14, 7), num_classes=10)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 64, 64, 3))
                         .astype(np.float32))
    runs = []
    for remat in (False, True):
        m = TinyViT(img_size=64, device="cpu", drop_path_rate=drop_path, remat_stem=remat,
                    **narrow)
        m.load_state_dict(seeded_state_dict(m, 3))
        m.train()
        g = torch.Generator().manual_seed(7)
        loss = m(x, g).square().mean()
        loss.backward()
        runs.append((loss.detach(), {k: p.grad for k, p in m.named_parameters()},
                     dict(m.named_buffers()), g.get_state()))
    (l0, g0, b0, s0), (l1, g1, b1, s1) = runs
    assert torch.equal(l0, l1) and torch.equal(s0, s1)
    assert all(torch.equal(g0[k], g1[k]) for k in g0)
    assert all(torch.equal(b0[k], b1[k]) for k in b0)
