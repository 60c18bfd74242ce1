"""cream_tpu_torch's CyDAS segmentation (`models/cydas_seg.py`,
`ops/resize.py`, `train/segmentation.py`, `data/segmentation.py`,
`cli/train_seg.py`) and its weight bridge, against the JAX package's on
shared seeded weights and numpy-seeded inputs (fp32, on the CPU).

Weights: `seeded_state_dict` on the port's model (SAGAN's `gamma` and the
zero-initialized `net.8` BN weights drawn U(0.5, 1.5), so the attention
branches count), carried to JAX by the JAX package's own importer,
`cream_tpu.zoo.import_torch.convert_cydas_seg`;
`zoo.load.cydas_seg_state_dict_from_jax` is its exact inverse. The full
width runs live at an odd, non-square 65 x 97 input (eval, and the
auxiliary heads on the running statistics). One train step at full width
is held to the record JAX wrote in float64 (`__main__`),
tests/data/torch_port/cydas_seg_seed0.npz, which also holds the fp32 eval
outputs at 97 x 129 for the card: per-class sums and seeded pixels.
Regenerate it with
    PYTHONPATH=.:tests python tests/test_torch_cydas_seg.py
"""
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cream_tpu.cli import train_seg as jax_train_seg
from cream_tpu.data import segmentation as JDS
from cream_tpu.models.cydas_seg import cydas_seg as jax_cydas_seg
from cream_tpu.ops.resize import bilinear_resize as jax_resize
from cream_tpu.train import segmentation as JS
from cream_tpu.zoo.import_torch import convert_cydas_seg
from cream_tpu_torch.cli import train_seg
from cream_tpu_torch.data import segmentation as DS
from cream_tpu_torch.models import create_model
from cream_tpu_torch.models import cydas_seg as C
from cream_tpu_torch.nn.layers import DW_REFUSED, set_dw_kernel
from cream_tpu_torch.ops import dwconv
from cream_tpu_torch.ops.resize import bilinear_resize
from cream_tpu_torch.train import segmentation as S
from cream_tpu_torch.train.state import TrainState
from cream_tpu_torch.zoo.load import cydas_seg_state_dict_from_jax, seeded_state_dict
from torch_port_bridges import assert_bridge_inverts
from torch_threads import one_torch_thread_module  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "data" / "torch_port" / "cydas_seg_seed0.npz"
WEIGHT_SEED, INPUT_SEED, LABEL_SEED, PIXEL_SEED = 0, 1, 2, 3
LIVE_HW, GOLDEN_HW = (65, 97), (97, 129)


def _np(t) -> np.ndarray:
    return t.detach().float().cpu().numpy().copy()


def jax_variables(sd: dict) -> dict:
    """The port's state_dict through the JAX package's importer."""
    return convert_cydas_seg({k: _np(v) for k, v in sd.items()
                              if not k.endswith("num_batches_tracked")})


def images(seed: int, batch: int, hw) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((batch, *hw, 3)).astype(np.float32)


def labels_for(seed: int, batch: int, hw, num_classes: int = 19) -> np.ndarray:
    """Blocky labels over the whole map (`synthetic_seg_batches`' draws at
    a seed of their own), the first two rows ignored."""
    return next(DS.synthetic_seg_batches(batch, hw, num_classes, 1, seed))["label"]


# ---------------------------------------------------------------- resize

@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("out_hw", [(26, 42), (7, 10), (13, 21), (13, 40), (20, 33), (1, 1)])
def test_bilinear_resize_matches_jax(align_corners, out_hw):
    """Both conventions, up and down, one axis alone, to a single pixel;
    input grads too (the transposed contractions)."""
    rng = np.random.default_rng(sum(out_hw))
    x = rng.standard_normal((2, 13, 21, 5)).astype(np.float32)
    w = rng.standard_normal((2, *out_hw, 5)).astype(np.float32)
    want, vjp = jax.vjp(lambda a: jax_resize(a, out_hw, align_corners), jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_()
    got = bilinear_resize(t, out_hw, align_corners)
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=2e-6)
    np.testing.assert_allclose(_np(t.grad), np.asarray(vjp(jnp.asarray(w))[0]), rtol=0,
                               atol=1e-5)
    if out_hw == (13, 21):
        assert got is t                                  # the size kept: x itself


def test_bilinear_resize_rounds_in_bf16_as_jax():
    """Under bf16 the matrices are cast to bf16 and the rows contract
    before the columns, as the JAX package's einsums: within 1 bf16 ulp of
    JAX's result where the bf16 dot runs on the CPU as fp32 products."""
    x = np.random.default_rng(7).standard_normal((1, 9, 11, 4)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = bilinear_resize(xb, (17, 5), False)
    assert got.dtype == torch.bfloat16
    want = np.asarray(jax_resize(jnp.asarray(x, jnp.bfloat16), (17, 5), False)
                      .astype(jnp.float32))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert np.all(np.abs(_np(got) - want) <= ulp + 1e-30)


# ----------------------------------------------------------------- model

@pytest.fixture(scope="module")
def live():
    torch.set_num_threads(1)
    m = create_model("cydas_seg", device="cpu")
    sd = seeded_state_dict(m, WEIGHT_SEED)
    m.load_state_dict(sd)
    v = jax_variables(sd)
    x = images(INPUT_SEED, 2, LIVE_HW)
    jm = jax_cydas_seg(num_classes=19)
    aux = jax.jit(lambda v, x: jm.apply(v, x, aux=True))(v, jnp.asarray(x))
    return dict(m=m, sd=sd, v=v, x=x, aux=[np.asarray(a) for a in aux])


def test_zero_init_parameters_are_drawn(live):
    """The seeded weights set what the init zeroes (SAGAN's gate, the
    attention branch's last BN weight), so the branches reach the output."""
    sd = live["sd"]
    for h in ("heads8", "heads16", "heads32"):
        assert float(sd[f"{h}.att_sa.net.3.gamma"]) >= 0.5
        assert float(sd[f"{h}.att_sa.net.8.weight"].abs().min()) >= 0.5
    fresh = create_model("cydas_seg", device="meta")
    assert set(fresh.state_dict()) == set(sd)


def test_full_width_eval_and_aux_heads_match_jax(live):
    """cydas_seg at an odd, non-square 65 x 97 input (maps 33 x 49 down to
    3 x 4, the attention blocks halving odd maps): the eval output and the
    three heads on the running statistics within 1e-5 of the largest."""
    m, x = live["m"], torch.from_numpy(live["x"])
    with torch.no_grad():
        pred = m(x)
        aux = m(x, aux=True)
    assert pred.shape == (2, *LIVE_HW, 19)
    assert torch.equal(pred, aux[0])
    for got, want in zip(aux, live["aux"]):
        np.testing.assert_allclose(_np(got), want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_bridge_inverts_the_jax_importer(live):
    assert_bridge_inverts(live["sd"], live["v"], cydas_seg_state_dict_from_jax)
    assert {"backbone.blocks.6.0.conv.weight", "arms32.1.conv.1.running_var",
            "refines32.0.conv.0.weight", "ffm.conv_1x1.bn.bias",
            "heads8.feature_projection.conv.0.weight", "heads8.att_sa.net.3.gamma",
            "heads8.conv_3x3.conv.weight", "heads32.att_sa.shortcut.1.weight",
            "heads16.conv_1x1.bias"} <= set(live["sd"])
    assert not any(k.startswith("heads16.att_sa.shortcut") for k in live["sd"])


def test_depthwise_sites_and_fused_route():
    """Six stride-1 depthwise 3x3 sites (16, 96, 160, 480, 384, 576
    channels) and none strided; at the 769 crop every map is odd and no
    site is refused. On the CPU "fused" runs K7's plain version: the
    forward equals the library route's within fp32 noise."""
    sites = C.dw3x3_sites(12, 769, 769)
    assert [s for s, _ in sites] == [1] * 6
    assert [shape[-1] for _, shape in sites] == [16, 96, 160, 480, 384, 576]
    assert [shape[1] for _, shape in sites] == [385, 193, 97, 49, 49, 49]
    assert all(dwconv.supports_fused(shape) for _, shape in sites)
    m = create_model("cydas_seg", device="cpu")
    m.load_state_dict(seeded_state_dict(m, 1))
    x = torch.from_numpy(images(3, 1, (33, 47)))
    with torch.no_grad():
        want = m(x)
        DW_REFUSED.clear()
        set_dw_kernel(m, "fused")
        got = m(x)
    assert not DW_REFUSED
    assert all(blk.dw_kernel == "fused" for blk in m.modules() if hasattr(blk, "dw_kernel"))
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1e-5 * float(want.abs().max()))


# ------------------------------------------------------------- the loss

@pytest.mark.parametrize("min_kept", [1, 64, 5000, 100000])
def test_ohem_matches_jax(min_kept):
    """The kept set at every threshold regime (thresh binding, the k-th
    probability binding, fewer valid pixels than min_kept): loss and logit
    grads within fp32 noise."""
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((2, 17, 23, 19)) * 3).astype(np.float32)
    labels = rng.integers(0, 19, (2, 17, 23)).astype(np.int32)
    labels[rng.random(labels.shape) < 0.3] = 255
    want, g = jax.value_and_grad(lambda z: JS.ohem_cross_entropy(
        z, jnp.asarray(labels), 0.7, min_kept))(jnp.asarray(logits))
    t = torch.from_numpy(logits).requires_grad_()
    got = S.ohem_cross_entropy(t, torch.from_numpy(labels), 0.7, min_kept)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=2e-6)
    np.testing.assert_allclose(_np(t.grad), np.asarray(g), rtol=0, atol=1e-7)


def test_confusion_and_miou_match_jax():
    """The int64 histogram equals JAX's fp32 one; per-batch intersections
    and unions; mIoU over the present classes (one class absent)."""
    rng = np.random.default_rng(2)
    pred = rng.integers(0, 6, (3, 11, 13))
    lab = rng.integers(0, 6, (3, 11, 13))
    lab[rng.random(lab.shape) < 0.2] = 255
    want = np.asarray(JS.seg_confusion(jnp.asarray(pred), jnp.asarray(lab), 7))
    hist = S.seg_confusion(torch.from_numpy(pred), torch.from_numpy(lab), 7)
    assert hist.dtype == torch.int64
    np.testing.assert_array_equal(hist.numpy(), want)
    inter, union = S.batch_intersection_union(torch.from_numpy(pred), torch.from_numpy(lab), 7)
    ji, ju = JS.batch_intersection_union(jnp.asarray(pred), jnp.asarray(lab), 7)
    np.testing.assert_array_equal(inter.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(union.numpy(), np.asarray(ju))
    miou, iou = S.miou_from_hist(hist)
    jmiou, jiou = JS.miou_from_hist(jnp.asarray(want))
    np.testing.assert_allclose(float(miou), float(jmiou), rtol=1e-6)
    np.testing.assert_allclose(iou.numpy(), np.asarray(jiou), rtol=1e-6)


# ---------------------------------------------------------- train step

@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


def golden_batch(golden) -> dict:
    hw = tuple(int(v) for v in golden["hw"])
    return {"image": torch.from_numpy(images(int(golden["input_seed"]), 2, hw)),
            "label": torch.from_numpy(labels_for(int(golden["label_seed"]), 2, hw))}


def test_full_width_eval_matches_golden(golden):
    """The fp32 record the card checks: per-class sums and seeded pixels of
    the eval output and the three heads at 97 x 129, within 1e-4 of the
    largest."""
    torch.set_num_threads(2)
    m = create_model("cydas_seg", device="cpu")
    m.load_state_dict(seeded_state_dict(m, int(golden["weight_seed"])))
    x = golden_batch(golden)["image"]
    with torch.no_grad():
        aux = torch.stack(m(x, aux=True), 1)          # (B, 3, H, W, C)
    got_sums = aux.double().sum((2, 3)).numpy()
    px = golden["pixels"]
    got_px = aux[:, :, px[:, 0], px[:, 1]].numpy()
    for got, want in ((got_sums, golden["head_sums"]), (got_px, golden["head_pixels"])):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_full_width_step_matches_float64_golden(golden):
    """The CLI's step at full width (train-mode BN, three OHEM losses at
    min_kept = B·H·W // 16) in fp32 against JAX's in float64: each loss
    within 1e-4, the global grad norm within 1e-4, per-tensor grad norms
    within 1e-3 (plus 1e-6 of the largest)."""
    torch.set_num_threads(2)
    m = create_model("cydas_seg", device="cpu")
    m.load_state_dict(seeded_state_dict(m, int(golden["weight_seed"])))
    b = golden_batch(golden)
    m.train()
    preds = m(b["image"])
    loss, parts = S.cydas_seg_loss(preds, b["label"], int(golden["min_kept"]))
    params = dict(m.named_parameters())
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    m.eval()
    assert abs(float(loss) - float(golden["loss"])) <= 1e-4 * float(golden["loss"])
    for k in ("loss8", "loss16", "loss32"):
        assert abs(float(parts[k]) - float(golden[k])) <= 1e-4 * float(golden[k])
    names = list(golden["names"])
    assert sorted(grads) == names
    got = np.asarray([float(grads[n].norm()) for n in names])
    want = golden["grad_norms"]
    gn = float(np.sqrt((got.astype(np.float64) ** 2).sum()))
    assert abs(gn - float(golden["grad_norm"])) <= 1e-4 * float(golden["grad_norm"])
    assert np.all(np.abs(got - want) <= 1e-3 * want + 1e-6 * want.max()), \
        (np.abs(got - want) / want).max()


# ------------------------------------------------------------------ data

def write_dataset(root: Path, n: int = 5) -> tuple[str, str]:
    from PIL import Image
    rng = np.random.default_rng(11)
    img_dir, lab_dir = root / "img", root / "lab"
    img_dir.mkdir()
    lab_dir.mkdir()
    for i in range(n):
        h, w = int(rng.integers(40, 70)), int(rng.integers(50, 90))
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            img_dir / f"f{i}.{'png' if i % 2 else 'jpg'}")
        lab = rng.integers(0, 19, (h, w)).astype(np.uint8)
        lab[rng.random((h, w)) < 0.1] = 255
        Image.fromarray(lab).save(lab_dir / f"f{i}.png")
    return str(img_dir), str(lab_dir)


def test_data_batches_equal_jax(tmp_path):
    """SegFolder on files the test writes: the seeded train batches
    (mirror, scale, crop and pad from (seed, epoch, index)) and the eval
    batches (fit, pad, an all-ignore tail) equal JAX's bit for bit; the
    synthetic batches too where 8 divides the size, and cover the image
    where it does not."""
    img_dir, lab_dir = write_dataset(tmp_path)
    ds, jds = DS.SegFolder(img_dir, lab_dir), JDS.SegFolder(img_dir, lab_dir)
    assert len(ds) == len(jds) == 5
    for ep in (0, 1):
        for a, b in zip(DS.seg_train_batches(ds, 2, (48, 56), seed=3, epoch=ep),
                        JDS.seg_train_batches(jds, 2, (48, 56), seed=3, epoch=ep)):
            for k in ("image", "label"):
                np.testing.assert_array_equal(a[k], b[k])
    n = 0
    for a, b in zip(DS.seg_eval_batches(ds, 2, (50, 60)), JDS.seg_eval_batches(jds, 2, (50, 60))):
        for k in ("image", "label"):
            np.testing.assert_array_equal(a[k], b[k])
        n += 1
    assert n == 3
    for a, b in zip(DS.synthetic_seg_batches(2, (32, 40), 7, 2, 5),
                    JDS.synthetic_seg_batches(2, (32, 40), 7, 2, 5)):
        for k in ("image", "label"):
            np.testing.assert_array_equal(a[k], b[k])
    odd = next(DS.synthetic_seg_batches(1, (37, 21), 7, 1, 0))
    assert odd["label"].shape == (1, 37, 21) and (odd["label"][:, :2] == 255).all()


def test_jax_synthetic_labels_do_not_cover_an_odd_crop():
    """The JAX package's synthetic labels are H // 8 x W // 8 blocks of 8:
    at the CLI's default 769 crop they are 768 x 768 beside 769 x 769
    images. The port's cover the image (ROADMAP Queue 3)."""
    jb = next(JDS.synthetic_seg_batches(1, (769, 769), 19, 1, 0))
    assert jb["image"].shape[1:3] == (769, 769) and jb["label"].shape[1:] == (768, 768)
    pb = next(DS.synthetic_seg_batches(1, (769, 769), 19, 1, 0))
    assert pb["label"].shape[1:] == (769, 769)
    np.testing.assert_array_equal(pb["image"], jb["image"])


def test_poly_warmup_lr_matches_jax():
    for warm in (0, 5):
        want = jax_train_seg.poly_warmup_lr(0.05, 5e-6, warm, 20)
        got = train_seg.poly_warmup_lr(0.05, 5e-6, warm, 20)
        for it in range(22):
            np.testing.assert_allclose(got(it), float(want(it)), rtol=1e-6)


def test_cli_synthetic_run_on_cpu(tmp_path):
    """The CLI's synthetic mode end to end on the CPU at an odd crop: finite
    losses, the poly LR, a running train mIoU."""
    out = tmp_path / "seg.json"
    res = train_seg.main(["--cpu", "--synthetic", "--steps", "3", "--crop", "41",
                          "--batch-size", "2", "--num-classes", "5", "--out", str(out)])
    h = res["history"]
    assert len(h) == 3 and all(np.isfinite(r["loss"]) for r in h)
    assert h[0]["lr"] == pytest.approx(0.05) and h[1]["lr"] < h[0]["lr"]
    assert 0.0 < h[-1]["train_miou"] <= 1.0 and out.exists()


def test_cli_step_is_the_sgd_of_the_jax_cli():
    """The CLI's optimizer: the decay added to every grad, then momentum
    0.9, the LR after (optax's add_decayed_weights + sgd)."""
    import optax
    m = torch.nn.Linear(3, 2)
    p0 = {k: v.detach().clone() for k, v in m.named_parameters()}
    g = {k: torch.full_like(v, 0.5) for k, v in p0.items()}
    tx = optax.chain(optax.add_decayed_weights(5e-4), optax.sgd(0.1, momentum=0.9))
    jp = {k: jnp.asarray(v.numpy()) for k, v in p0.items()}
    st = tx.init(jp)
    state = TrainState(m, train_seg.seg_sgd(0.1))
    for _ in range(2):
        u, st = tx.update({k: jnp.asarray(v.numpy()) for k, v in g.items()}, st, jp)
        jp = optax.apply_updates(jp, u)
        state.apply_gradients(g)
    for k, p in m.named_parameters():
        np.testing.assert_allclose(_np(p), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)


def write_golden(path: Path = GOLDEN) -> None:
    """JAX's cydas_seg on the port's seeded weights at 97 x 129: the eval
    heads in fp32, one train step in float64."""
    port = create_model("cydas_seg", device="cpu")
    sd = seeded_state_dict(port, WEIGHT_SEED)
    v = jax_variables(sd)
    x = images(INPUT_SEED, 2, GOLDEN_HW)
    lab = labels_for(LABEL_SEED, 2, GOLDEN_HW)
    jm = jax_cydas_seg(num_classes=19)
    aux = np.stack([np.asarray(a) for a in jax.jit(
        lambda v, x: jm.apply(v, x, aux=True))(v, jnp.asarray(x))], 1)
    rng = np.random.default_rng(PIXEL_SEED)
    pixels = np.stack([rng.integers(0, GOLDEN_HW[0], 64), rng.integers(0, GOLDEN_HW[1], 64)], 1)
    min_kept = 2 * GOLDEN_HW[0] * GOLDEN_HW[1] // 16
    jax.config.update("jax_enable_x64", True)
    jm = jax_cydas_seg(num_classes=19, dtype=jnp.float64)
    v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), v)

    def loss_fn(p):
        preds, _ = jm.apply({"params": p, "batch_stats": v["batch_stats"]},
                            jnp.asarray(x, jnp.float64), train=True, mutable=["batch_stats"])
        return JS.cydas_seg_loss(preds, jnp.asarray(lab), min_kept)
    (loss, parts), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(v["params"])
    jax.config.update("jax_enable_x64", False)
    named = cydas_seg_state_dict_from_jax({"params": grads, "batch_stats": v["batch_stats"]})
    names = sorted(n for n, _ in port.named_parameters())
    np.savez_compressed(
        path, weight_seed=WEIGHT_SEED, input_seed=INPUT_SEED, label_seed=LABEL_SEED,
        hw=np.asarray(GOLDEN_HW), pixels=pixels, head_sums=aux.astype(np.float64).sum((2, 3)),
        head_pixels=aux[:, :, pixels[:, 0], pixels[:, 1]], min_kept=min_kept,
        loss=float(loss), **{k: float(t) for k, t in parts.items()}, names=np.asarray(names),
        grad_norms=np.asarray([np.linalg.norm(named[n].numpy()) for n in names], np.float32),
        grad_norm=float(np.sqrt(sum(np.sum(np.square(np.asarray(g), dtype=np.float64))
                                    for g in jax.tree_util.tree_leaves(grads)))))
    print(f"wrote {path} ({path.stat().st_size} bytes), loss {float(loss):.6f}")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    write_golden()
