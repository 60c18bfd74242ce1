"""cream_tpu_torch's fast pretraining distillation vs the JAX package's, on
the CPU: the sparse teacher-logits store (byte for byte, each package
reading the other's), the native codec, the loader's per-sample seeds and
epoch order (with and without repeated augmentation), the 22k -> 1k remap
(and the JAX package's two remaps that disagree), the teacher's top-K on a
narrow Swin, the distill train step of a narrow TinyViT over three steps,
the full-width TinyViT-21M-224 distill step against the stored JAX golden,
and the save_logits -> --check -> distill-train CLIs with their refusals.

Regenerate the golden file (one fp32 JAX distill step of TinyViT-21M-224 at
B=2 on the seeded weights) with
    PYTHONPATH=.:tests python tests/test_torch_distill.py
"""
import copy
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cream_tpu.data.det_aug import sample_seed as jax_sample_seed
from cream_tpu.data.imagenet import SyntheticDataset as JaxSyntheticDataset
from cream_tpu.data.imagenet import train_loader as jax_train_loader
from cream_tpu.distill.logits_store import LogitsReader as JaxReader
from cream_tpu.distill.logits_store import LogitsWriter as JaxWriter
from cream_tpu.distill.pipeline import make_distill_train_step as jax_make_distill_step
from cream_tpu.models import create_model as jax_create_model
from cream_tpu.models.swin import SwinTransformer as JaxSwin
from cream_tpu.train import TrainState as JaxTrainState
from cream_tpu.train import losses as jax_losses
from cream_tpu.train import optim as jax_optim
from cream_tpu.zoo.import_torch import convert_swin, convert_tinyvit
from cream_tpu.zoo.interpolate import remap_leaf as jax_remap_leaf
from cream_tpu.zoo.remap import remap_22k_to_1k as jax_remap_22k_to_1k
from cream_tpu_torch.cli import save_logits, train
from cream_tpu_torch.core.config import Config
from cream_tpu_torch.data import mixup
from cream_tpu_torch.data.det_aug import sample_seed
from cream_tpu_torch.data.imagenet import SyntheticDataset, train_loader
from cream_tpu_torch.distill import LogitsReader, LogitsWriter, native
from cream_tpu_torch.distill.logits_store import check_recipe
from cream_tpu_torch.distill.pipeline import make_distill_train_step, replay_recipe
from cream_tpu_torch.models import create_model
from cream_tpu_torch.models.swin import SwinTransformer
from cream_tpu_torch.models.tinyvit import TinyViT
from cream_tpu_torch.train import losses, optim
from cream_tpu_torch.train.state import TrainState
from cream_tpu_torch.train.steps import loss_and_grads
from cream_tpu_torch.zoo.load import (load_for_model, seeded_state_dict,
                                      swin_state_dict_from_jax)
from cream_tpu_torch.zoo.remap import load_1k_to_22k, remap_22k_to_1k

from test_torch_train import (BATCH, IMG, LR, NARROW, _jax_loss_and_grads, _jax_tree,
                              _leaves, _name_bridge, _narrow_pair, _np_sd)
from torch_threads import one_torch_thread_module  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "data" / "torch_port" / "tinyvit_21m_224_distill_seed0.npz"
WEIGHT_SEED, INPUT_SEED = 0, 1


def _records(rng, N, K, C):
    vals = (rng.random((N, K)) * 0.3).astype(np.float32)
    idxs = rng.integers(0, C, (N, K)).astype(np.int32)
    seeds = rng.integers(0, 2 ** 31, (N,)).astype(np.int32)
    return vals, idxs, seeds


def _write(cls, root, vals, idxs, seeds, order, **kw):
    """Write the records in `order`, 16 at a time, and close."""
    N, K = vals.shape
    w = cls(str(root), 0, N, K, 1000, **kw)
    for i in range(0, N, 16):
        sel = order[i:i + 16]
        w.write_batch(sel, seeds[sel], vals[sel], idxs[sel])
    w.close()


def _files(root):
    return (Path(root) / "epoch0.bin").read_bytes(), (Path(root) / "meta.json").read_bytes()


# ---- the store ----

@pytest.mark.parametrize("use_native", [True, False])
def test_store_bytes_equal_jax(tmp_path, use_native):
    """The port's writer (native codec or numpy) and JAX's numpy writer give
    the same epoch0.bin and meta.json bytes, records written out of order."""
    rng = np.random.default_rng(0)
    vals, idxs, seeds = _records(rng, 64, 7, 1000)
    order = rng.permutation(64)
    _write(LogitsWriter, tmp_path / "port", vals, idxs, seeds, order, use_native=use_native)
    _write(JaxWriter, tmp_path / "jax", vals, idxs, seeds, order, use_native=False)
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")


@pytest.mark.parametrize("port_native", [True, False])
def test_each_package_reads_the_others_store(tmp_path, port_native):
    rng = np.random.default_rng(1)
    vals, idxs, seeds = _records(rng, 48, 5, 1000)
    order = rng.permutation(48)
    f16 = vals.astype(np.float16).astype(np.float32)
    _write(LogitsWriter, tmp_path / "port", vals, idxs, seeds, order, use_native=port_native)
    _write(JaxWriter, tmp_path / "jax", vals, idxs, seeds, order, use_native=False)
    ask = rng.permutation(48)[:20]
    for got in (JaxReader(str(tmp_path / "port"), 0, use_native=False).read_batch(ask),
                LogitsReader(str(tmp_path / "jax"), 0, use_native=port_native).read_batch(ask)):
        np.testing.assert_array_equal(got[0], f16[ask])
        np.testing.assert_array_equal(got[1], idxs[ask])
        np.testing.assert_array_equal(got[2], seeds[ask])


FP16_CASES = {
    "exact": [0.5, 0.25, 0.125, 0.0625],
    "small": [1.0, 0.0, 2.0 ** -14, 0.099975586],
    "rounding": [0.33325195, 0.19995117, 0.10003662, 0.04998779],
    "range": [65504.0, 1e-8, 0.1, 0.3],
    "subnormal_ties": [2.0 ** -24, 3 * 2.0 ** -25, 2.0 ** -25, 6e-5],
    "even_ties": [1 + 2.0 ** -11, 1 + 3 * 2.0 ** -11, 2049.0, 2051.0],
    "overflow": [65519.0, 65520.0, 70000.0, -70000.0],
    "nonfinite": [np.nan, np.inf, -np.inf, 1.5],
    "signed_zero": [0.0, -0.0, np.nan, 65504.0],
}


@pytest.mark.parametrize("case", sorted(FP16_CASES))
def test_fp16_edge_cases_match_jax(tmp_path, case):
    """The port's C++ fp32 -> fp16 (round to nearest even, subnormals, NaN
    kept quiet, overflow to inf) writes JAX's numpy writer's bytes; read
    back they equal numpy's float16 values (NaN where NaN)."""
    vals = np.asarray([FP16_CASES[case]], np.float32)
    idxs, seeds = np.arange(4, dtype=np.int32)[None], np.asarray([7], np.int32)
    for cls, d, kw in ((LogitsWriter, "port", {"use_native": True}),
                       (JaxWriter, "jax", {"use_native": False})):
        w = cls(str(tmp_path / d), 0, 1, 4, 10, **kw)
        w.write_batch(np.arange(1), seeds, vals, idxs)
        w.close()
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    got = LogitsReader(str(tmp_path / "port"), 0).read_batch(np.arange(1))[0]
    want = vals.astype(np.float16).astype(np.float32)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[~np.isnan(want)], want[~np.isnan(want)])


def test_store_refusals(tmp_path):
    """An incompatible meta.json, classes past int16 and indices outside
    the store raise, as in JAX (the index check is the port's own)."""
    LogitsWriter(str(tmp_path), 0, 8, 4, 1000).close()
    with pytest.raises(ValueError, match="incompatible"):
        LogitsWriter(str(tmp_path), 1, 8, 5, 1000)
    with pytest.raises(ValueError, match="int16"):
        LogitsWriter(str(tmp_path / "wide"), 0, 8, 4, 40000)
    r = LogitsReader(str(tmp_path), 0)
    with pytest.raises(IndexError):
        r.read_batch(np.asarray([8]))
    r.close()


def test_native_codec_build_failure_raises(tmp_path, monkeypatch):
    """Asking for the native codec when it cannot be built raises (JAX falls
    back to numpy); use_native=False is the explicit numpy path."""
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    native.load.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="logits codec"):
            LogitsWriter(str(tmp_path / "store"), 0, 4, 2, 10)
        with pytest.raises(RuntimeError, match="logits codec"):
            LogitsReader(str(tmp_path / "store"), 0)
        w = LogitsWriter(str(tmp_path / "store"), 0, 4, 2, 10, use_native=False)
        w.write_batch(np.arange(4), np.arange(4), np.full((4, 2), 0.25), np.ones((4, 2)))
        w.close()
    finally:
        native.load.cache_clear()
    assert not (tmp_path / "build").exists() or not list((tmp_path / "build").glob("*.so"))


def test_native_codec_library_is_named_by_its_source_and_flags(monkeypatch):
    path = native.build()
    assert path.exists() and path.parent == native.BUILD_DIR
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-g",))
    assert native.library_path() != path


# ---- the loader ----

@pytest.mark.parametrize("base,epoch,index", [(0, 0, 0), (0, 3, 17), (7, 1, 123456),
                                              (2 ** 31 - 1, 299, 1281166), (101 * 2, 5, 9)])
def test_sample_seed_matches_jax(base, epoch, index):
    assert sample_seed(base, epoch, index) == jax_sample_seed(base, epoch, index)


@pytest.mark.parametrize("repeated_aug", [0, 3])
@pytest.mark.parametrize("n,batch,epoch,base_seed", [
    (10, 3, 0, 0), (64, 8, 2, 5), (37, 4, 1, 123), (100, 16, 7, 2 ** 20)])
def test_train_loader_index_seed_and_label_match_jax(n, batch, epoch, base_seed,
                                                     repeated_aug):
    """The same epoch order, labels, per-sample seeds and pixels (the
    default seeded random resized crop + flip) as the JAX loader."""
    got = list(train_loader(SyntheticDataset(n, 8, 10), batch, epoch, base_seed, 8, 2,
                            repeated_aug=repeated_aug))
    want = list(jax_train_loader(JaxSyntheticDataset(n, 8, 10), batch, epoch, base_seed,
                                 8, 2, repeated_aug=repeated_aug))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for k in ("index", "seed", "label"):
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            assert g[k].dtype == np.int32
        assert g["image"].shape == (batch, 8, 8, 3)
        np.testing.assert_array_equal(g["image"], w["image"])


# ---- the remap ----

def _mapping(rng, missing):
    mapping = rng.choice(21841, 1000, replace=False).astype(np.int32)
    mapping[rng.choice(1000, missing, replace=False)] = -1
    return mapping


def _softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


@pytest.mark.parametrize("missing", [0, 3])
def test_remap_matches_jax_and_the_two_jax_routes(tmp_path, missing):
    """The port's remap equals `cream_tpu/zoo/remap.py`'s (-inf where the
    mapping holds -1). JAX's save_logits indexes `logits[:, mapping]`
    (`cream_tpu/cli/save_logits.py:111`): without a -1 it agrees; with one
    it reads the last 22k class's logit and gives an absent class a
    probability above 0, where the port (and `zoo/remap.py`) give 0."""
    rng = np.random.default_rng(11 + missing)
    logits = (rng.standard_normal((4, 21841)) * 3).astype(np.float32)
    mapping = _mapping(rng, missing)
    np.savetxt(tmp_path / "map.txt", mapping, fmt="%d")
    np.testing.assert_array_equal(load_1k_to_22k(str(tmp_path / "map.txt")), mapping)
    port = remap_22k_to_1k(torch.from_numpy(logits), mapping).numpy()
    np.testing.assert_array_equal(port, np.asarray(jax_remap_22k_to_1k(jnp.asarray(logits),
                                                                       mapping)))
    save_route = np.asarray(jnp.asarray(logits)[:, jnp.asarray(mapping)])
    p_port, p_save = _softmax(port.astype(np.float64)), _softmax(save_route.astype(np.float64))
    absent = mapping < 0
    if not missing:
        np.testing.assert_array_equal(save_route, port)
        return
    assert (p_port[:, absent] == 0).all()
    np.testing.assert_array_equal(save_route[:, absent],
                                  np.repeat(logits[:, -1:], missing, axis=1))
    assert (p_save[:, absent] > 0).all()
    # the JAX save_logits route's extra classes take their mass from the
    # others: every class's probability is lower there
    present = ~absent
    assert (p_save[:, present] < p_port[:, present]).all()


# ---- the teacher ----

NARROW_SWIN = dict(embed_dims=(32, 64, 64, 128), depths=(2, 2, 2, 2),
                   num_heads=(1, 2, 2, 4), window_sizes=7, num_classes=1200)


@pytest.fixture(scope="module")
def narrow_teacher():
    """A narrow Swin teacher of 1200 classes; the port's weights come from
    the JAX variables through `swin_state_dict_from_jax`. The JAX side's
    jitted apply is shared by the cases."""
    seeded = SwinTransformer(img_size=64, device="cpu", **NARROW_SWIN)
    variables = convert_swin(_np_sd(seeded_state_dict(seeded, 3)),
                             depths=NARROW_SWIN["depths"])
    m = SwinTransformer(img_size=64, device="cpu", **NARROW_SWIN)
    m.load_state_dict(swin_state_dict_from_jax(variables))
    return m.eval(), jax.jit(JaxSwin(**NARROW_SWIN).apply), variables


@pytest.mark.parametrize("remap", [False, True])
@pytest.mark.parametrize("mix", [False, True])
def test_teacher_topk_matches_jax(narrow_teacher, remap, mix):
    """fp32 top-K probabilities of a narrow Swin teacher: the port's
    save_logits core against JAX's `topk_probs` logic (apply, remap by
    `logits[:, mapping]`, fp32 softmax, `lax.top_k`) on the same pixels
    (the port's seeded pair mixup draws its own numbers, so the JAX side
    gets the port's mixed images). Values within 1e-6; indices equal, or,
    where values tie, the stored class's JAX probability equal to its
    value."""
    m, japply, variables = narrow_teacher
    rng = np.random.default_rng(21)
    x = rng.standard_normal((6, 64, 64, 3)).astype(np.float32)
    seeds = rng.integers(0, 2 ** 31, 6)
    mapping = rng.choice(1200, 1000, replace=False).astype(np.int32) if remap else None
    cfg = Config.from_yaml(None, [] if mix else ["aug.mixup=0", "aug.cutmix=0"])
    K = 10
    probs = save_logits.make_teacher_probs(
        cfg, m, torch.float32, None if mapping is None else torch.from_numpy(mapping))
    got_v, got_i = (t.numpy() for t in probs(torch.from_numpy(x), seeds).topk(K, -1))
    if mix:
        x = mixup.seeded_pair_mixup(seeds, torch.from_numpy(x), torch.zeros(6, dtype=torch.int64),
                                    1, cfg.aug.mixup, cfg.aug.cutmix,
                                    cfg.aug.mixup_switch_prob)[0].numpy()
    logits = japply(variables, jnp.asarray(x))
    if mapping is not None:
        logits = logits[:, jnp.asarray(mapping)]
    dense = jax.nn.softmax(logits.astype(jnp.float32), -1)
    want_v, want_i = (np.asarray(t) for t in jax.lax.top_k(dense, K))
    np.testing.assert_allclose(got_v, want_v, atol=1e-6, rtol=0)
    dense = np.asarray(dense)
    tied = np.abs(np.take_along_axis(dense, got_i.astype(np.int64), -1) - got_v) <= 1e-6
    assert ((got_i == want_i) | tied).all()


def test_teacher_and_student_pixels_within_one_bf16_ulp():
    """The teacher sees bf16(mix(x)), the student bf16(mix(bf16(x))) (both
    packages' rounding points: save_logits mixes fp32 images, the trainer
    mixes the compute-dtype ones in fp32); each pixel of the two is at most
    1 bf16 ulp of the larger of its two source pixels apart. The mix of
    bf16 images is fp32, as JAX's fp32 lambda makes it."""
    rng = np.random.default_rng(31)
    x = torch.from_numpy(rng.standard_normal((64, 32, 32, 3)).astype(np.float32))
    seeds = rng.integers(0, 2 ** 31, 64)
    zeros = torch.zeros(64, dtype=torch.int64)
    teacher = mixup.seeded_pair_mixup(seeds, x, zeros, 1)[0].to(torch.bfloat16)
    mixed = mixup.seeded_pair_mixup(seeds, x.to(torch.bfloat16), zeros, 1)[0]
    assert mixed.dtype == torch.float32
    student = mixed.to(torch.bfloat16)
    pairs = x.reshape(32, 2, 32, 32, 3)
    source = torch.maximum(pairs.abs(), pairs.flip(1).abs()).reshape(x.shape)
    ulp = 2.0 ** (torch.floor(torch.log2(source.clamp(min=2.0 ** -126))) - 7)
    apart = (teacher.float() - student.float()).abs() / ulp
    assert apart.max().item() <= 1.0
    assert (apart > 0).any()          # the two rounding points do differ


# ---- the distill step ----

def _topk_batch(rng, batch, classes, K):
    """Top-K of a seeded teacher distribution, rounded as the fp16 store
    rounds it: (values fp32, indices int32)."""
    p = _softmax(rng.standard_normal((batch, classes)) * 2.0)
    idx = np.argsort(-p, -1)[:, :K].astype(np.int32)
    vals = np.take_along_axis(p, idx, -1).astype(np.float16).astype(np.float32)
    return vals, idx


def _distill_ce(logits, target):
    """JAX's distillation loss on the dense target of the stored top-K."""
    return jax_losses.soft_target_ce(logits.astype(jnp.float32), target)


def _dense_target(num_classes, vals, idx):
    return jax_losses.dense_from_topk(jnp.asarray(vals), jnp.asarray(idx), num_classes)


def test_narrow_tinyvit_three_distill_steps_match_jax():
    """Three distill steps of a narrow TinyViT against JAX's
    `make_distill_train_step`: loss, teacher_agree and grad_norm each step
    (rtol 1e-5), the raw grads per tensor at the pre-step state (relative L2
    1e-4 above the noise floor), the params at the end (2x the summed lrs),
    at the tolerances of the classification step's three-step test."""
    m, jm, variables = _narrow_pair()
    depths = NARROW["depths"]
    C, K = NARROW["num_classes"], 4
    jtx = jax_optim.make_adamw(jax_optim.cosine_schedule(*LR.values()),
                               weight_decay=0.05, clip_grad=5.0,
                               params=variables["params"])
    jstate = JaxTrainState.create(params=variables["params"], tx=jtx,
                                  batch_stats=variables["batch_stats"])
    jstep = jax_make_distill_step(jm, C)
    tx = optim.make_adamw(optim.cosine_schedule(*LR.values()), weight_decay=0.05,
                          clip_grad=5.0, params=dict(m.named_parameters()))
    state = TrainState(m, tx)
    step = make_distill_train_step(C)
    rng = np.random.default_rng(40)
    lrs = []
    for i in range(3):
        x = rng.standard_normal((BATCH, IMG, IMG, 3)).astype(np.float32)
        vals, idx = _topk_batch(rng, BATCH, C, K)
        target = losses.dense_from_topk(torch.from_numpy(vals), torch.from_numpy(idx), C)
        _, _, grads = loss_and_grads(copy.deepcopy(m), {
            "image": torch.from_numpy(x), "label": target},
            lambda lg, y: losses.soft_target_ce(lg.float(), y))
        _, jgrads = _jax_loss_and_grads(jm, jstate.params, jstate.batch_stats,
                                        jnp.asarray(x), _dense_target(C, vals, idx),
                                        _distill_ce)
        lrs.append(state.tx.lr())
        batch = {"image": torch.from_numpy(x), "topk_values": torch.from_numpy(vals),
                 "topk_indices": torch.from_numpy(idx)}
        state, metrics = step(state, batch)
        jstate, jmetrics = jstep(jstate, {"image": jnp.asarray(x),
                                          "topk_values": jnp.asarray(vals),
                                          "topk_indices": jnp.asarray(idx)},
                                 jax.random.key(0))
        assert set(metrics) == set(jmetrics) == {"loss", "teacher_agree", "grad_norm"}
        for k in metrics:
            np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-5,
                                       err_msg=k)
        got = _leaves(_jax_tree(m, grads, depths)["params"])
        want = _leaves(jgrads)
        assert set(got) == set(want)
        floor = 1e-7 * float(jmetrics["grad_norm"])
        for k in want:
            err = np.linalg.norm(got[k] - want[k])
            assert err <= 1e-4 * np.linalg.norm(want[k]) + floor, (k, err)
    tol = 2 * sum(lrs)
    got = _jax_tree(m, state.params, depths)
    for k, w in _leaves(jstate.params).items():
        np.testing.assert_allclose(_leaves(got["params"])[k], w, atol=tol, rtol=0,
                                   err_msg=k)
    assert state.step == int(jstate.step) == 3


def _golden_batch():
    rng = np.random.default_rng(INPUT_SEED)
    x = rng.standard_normal((2, 224, 224, 3)).astype(np.float32)
    vals, idx = _topk_batch(rng, 2, 1000, 100)
    return x, vals, idx


def jax_tinyvit21m_distill_golden() -> dict:
    """One fp32 JAX distill step of TinyViT-21M-224 (drop path 0) on the
    seeded weights and a seeded top-100 teacher: loss, grad_norm,
    teacher_agree and per-param grad norms keyed by the port's names, with
    the batch's top-K."""
    port = create_model("tiny_vit_21m_224", device="cpu")
    variables = convert_tinyvit(_np_sd(seeded_state_dict(port, WEIGHT_SEED)))
    jm = jax_create_model("tiny_vit_21m_224", drop_path_rate=0.0)
    x, vals, idx = _golden_batch()
    loss, grads = _jax_loss_and_grads(jm, variables["params"], variables["batch_stats"],
                                      jnp.asarray(x), _dense_target(1000, vals, idx),
                                      _distill_ce)
    import optax
    jstate = JaxTrainState.create(params=variables["params"], tx=optax.sgd(0.0),
                                  batch_stats=variables["batch_stats"])
    _, metrics = jax_make_distill_step(jm, 1000)(jstate, {
        "image": jnp.asarray(x), "topk_values": jnp.asarray(vals),
        "topk_indices": jnp.asarray(idx)}, jax.random.key(0))
    np.testing.assert_allclose(float(metrics["loss"]), float(loss), rtol=1e-6)
    bridge = _name_bridge(port, (2, 2, 6, 2))
    norms = {bridge[path]: float(np.linalg.norm(g)) for path, g in _leaves(grads).items()}
    names = sorted(norms)
    return {"loss": np.float32(loss), "grad_norm": np.float32(optax.global_norm(grads)),
            "teacher_agree": np.float32(metrics["teacher_agree"]),
            "names": np.asarray(names),
            "grad_norms": np.asarray([norms[n] for n in names], np.float32),
            "topk_values": vals, "topk_indices": idx,
            "input_seed": np.int64(INPUT_SEED), "weight_seed": np.int64(WEIGHT_SEED)}


def test_full_width_21m_distill_step_matches_jax_golden():
    """The port's fp32 distill step of TinyViT-21M-224 (B=2, drop path 0)
    against the stored JAX golden: loss 1e-5, grad_norm 1e-4, per tensor
    1e-3 (as the classification step's golden test)."""
    g = np.load(GOLDEN)
    assert int(g["input_seed"]) == INPUT_SEED and int(g["weight_seed"]) == WEIGHT_SEED
    x, vals, idx = _golden_batch()
    np.testing.assert_array_equal(vals, g["topk_values"])
    np.testing.assert_array_equal(idx, g["topk_indices"])
    m = create_model("tiny_vit_21m_224", device="cpu", drop_path_rate=0.0)
    m.load_state_dict(seeded_state_dict(m, WEIGHT_SEED))
    state = TrainState(m, optim.make_adamw(1e-3))
    grads = {}
    # the raw grads the step hands to the optimizer
    state.apply_gradients = lambda g: grads.update(g) or state
    _, metrics = make_distill_train_step(1000)(state, {
        "image": torch.from_numpy(x), "topk_values": torch.from_numpy(vals),
        "topk_indices": torch.from_numpy(idx)})
    np.testing.assert_allclose(float(metrics["loss"]), float(g["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(g["grad_norm"]), rtol=1e-4)
    assert float(metrics["teacher_agree"]) == float(g["teacher_agree"])
    assert sorted(grads) == list(g["names"])
    got = np.asarray([float(grads[n].norm()) for n in g["names"]])
    # per tensor 1e-3; grads that are zero up to float noise at the noise
    # floor
    np.testing.assert_allclose(got, g["grad_norms"], rtol=1e-3,
                               atol=1e-7 * float(g["grad_norm"]))


# ---- checkpoints with other tables ----

def test_load_for_model_remaps_position_tables(tmp_path):
    """A released-layout .pth at 224 loads into a model at 384: TinyViT's
    attention_biases (windows 7 -> 12) and Swin's relative-position tables
    (window 7 -> 12) are bicubic-remapped as the JAX loader remaps them;
    another mismatch raises."""
    src = create_model("tiny_vit_5m_224", device="cpu")
    sd = seeded_state_dict(src, 2)
    torch.save({"model": sd}, tmp_path / "tv.pth")
    dst = TinyViT(img_size=384, embed_dims=(64, 128, 160, 320), depths=(2, 2, 6, 2),
                  num_heads=(2, 4, 5, 10), window_sizes=(12, 12, 24, 12), device="cpu")
    got = load_for_model(dst, str(tmp_path / "tv.pth"))
    dst.load_state_dict(got)
    key = "layers.1.blocks.0.attn.attention_biases"
    assert tuple(sd[key].shape) != tuple(got[key].shape)
    want = jax_remap_leaf("attention_biases", sd[key].numpy(), tuple(got[key].shape))
    np.testing.assert_array_equal(got[key].numpy(), want)
    swin = SwinTransformer(img_size=64, device="cpu", **NARROW_SWIN)
    ssd = seeded_state_dict(swin, 4)
    torch.save(ssd, tmp_path / "swin.pth")
    big = SwinTransformer(img_size=96, device="cpu", **dict(NARROW_SWIN, window_sizes=12))
    got = load_for_model(big, str(tmp_path / "swin.pth"))
    key = "layers.0.blocks.0.attn.relative_position_bias_table"
    want = jax_remap_leaf("relative_position_bias_table", ssd[key].numpy(),
                          tuple(got[key].shape))
    np.testing.assert_array_equal(got[key].numpy(), want)
    big.load_state_dict(got)
    wrong = SwinTransformer(img_size=64, device="cpu", **dict(NARROW_SWIN, num_classes=10))
    with pytest.raises(ValueError, match="no interpolation rule"):
        load_for_model(wrong, str(tmp_path / "swin.pth"))


# ---- the CLIs ----

TEACHER = ["model.name=swin_tiny", "model.num_classes=21841", "model.dtype=float32",
           "model.img_size=64", "data.img_size=64", "data.dataset=synthetic",
           "data.batch_size=4", "data.num_workers=2", "distill.logits_topk=10"]
STUDENT = ["model.name=tiny_vit_5m_224", "model.dtype=float32", "model.img_size=64",
           "data.img_size=64", "data.dataset=synthetic", "data.batch_size=4",
           "data.num_workers=2", "train.warmup_epochs=0", "train.epochs=1",
           "distill.enabled=true"]


@pytest.fixture(scope="module")
def teacher_store(tmp_path_factory):
    """A narrow run of save_logits: swin_tiny at 64 pixels with the 22k head,
    a seeded 1k -> 22k mapping with 3 absent classes, 64 synthetic images."""
    d = tmp_path_factory.mktemp("distill")
    mapping = _mapping(np.random.default_rng(5), 3)
    np.savetxt(d / "map.txt", mapping, fmt="%d")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        summary = save_logits.main(["--device", "cpu", "--out", str(d / "store"),
                                    "--allow-random", "--remap-1kto22k", str(d / "map.txt"),
                                    *TEACHER])
    finally:
        torch.set_num_threads(n)
    return d, mapping, summary


def test_save_logits_writes_a_store_that_checks(teacher_store):
    d, mapping, (summary,) = teacher_store
    assert summary["records"] == 64 and summary["native"]
    r = LogitsReader(str(d / "store"), 0)
    assert (r.topk, r.num_classes, r.num_samples) == (10, 1000, 64)
    vals, idxs, seeds = r.read_batch(np.arange(64))
    assert list(seeds) == [sample_seed(0, 0, i) for i in range(64)]
    assert not np.isin(idxs, np.flatnonzero(mapping < 0)).any()
    assert (vals.sum(-1) < 1).all() and (np.diff(vals, axis=-1) <= 0).all()
    meta = json.loads((d / "store" / "meta.json").read_text())
    assert set(meta) == {"version", "topk", "num_classes", "num_samples", "record_size"}
    assert json.loads((d / "store" / "recipe.json").read_text()) == \
        replay_recipe(Config.from_yaml(None, TEACHER))
    (check,) = save_logits.main(["--device", "cpu", "--out", str(d / "store"), "--check",
                                 "--allow-random", "--remap-1kto22k", str(d / "map.txt"),
                                 *TEACHER])
    # the fp16 store: 2^-11 relative; the same fp32 teacher on the CPU
    assert check["n"] == 64 and check["value_max_err"] <= 1e-3
    assert check["index_miss_rate"] == 0.0 and check["index_diff_rate"] == 0.0


def test_distill_train_cli_replays_the_store(teacher_store, tmp_path, monkeypatch):
    """Distill training on the store: the loader runs without repeated
    augmentation (as JAX's), the loss is finite and the steps are the
    store's batches; without distillation `aug.repeated_aug` reaches the
    loader."""
    d, _, _ = teacher_store
    seen = []
    real = train.train_loader

    def spy(*a, **kw):
        seen.append(kw["repeated_aug"])
        return real(*a, **kw)

    monkeypatch.setattr(train, "train_loader", spy)
    acc = train.main(["--device", "cpu", *STUDENT, f"output={tmp_path}", "aug.repeated_aug=3",
                      f"distill.teacher_logits_path={d / 'store'}", "train.nan_budget=0"])
    assert 0.0 <= acc <= 100.0 and seen == [0]
    train.main(["--device", "cpu", *STUDENT[:-1], f"output={tmp_path / 'plain'}",
                "aug.repeated_aug=3"])
    assert seen == [0, 3]


@pytest.mark.parametrize("fault", ["no_recipe", "other_recipe", "seed", "no_path"])
def test_distill_train_refuses_a_store_it_cannot_replay(teacher_store, tmp_path, fault):
    d, _, _ = teacher_store
    store = tmp_path / "store"
    shutil.copytree(d / "store", store)
    opts = ["--device", "cpu", *STUDENT, f"output={tmp_path}",
            f"distill.teacher_logits_path={store}"]
    if fault == "no_recipe":
        (store / "recipe.json").unlink()
        with pytest.raises(ValueError, match="no recipe.json"):
            train.main(opts)
    elif fault == "other_recipe":
        with pytest.raises(ValueError, match="recipe"):
            train.main([*opts, "aug.mixup=0.5"])
    elif fault == "seed":
        first = next(iter(train_loader(SyntheticDataset(64, 64, 1000), 4, 0, 0, 64, 1)))
        with open(store / "epoch0.bin", "r+b") as f:
            f.seek(int(first["index"][1]) * (4 + 4 * 10))
            f.write(np.int32(12345).tobytes())
        with pytest.raises(ValueError, match="seeds"):
            train.main(opts)
        with pytest.raises(ValueError, match="seeds"):
            save_logits.main(["--device", "cpu", "--out", str(store), "--check",
                              "--allow-random", "--remap-1kto22k", str(d / "map.txt"),
                              *TEACHER])
    else:
        with pytest.raises(NotImplementedError, match="teacher_logits_path"):
            train.main(["--device", "cpu", *STUDENT, f"output={tmp_path}"])


def test_save_logits_refuses_a_random_teacher(tmp_path):
    with pytest.raises(SystemExit, match="RANDOM"):
        save_logits.main(["--device", "cpu", "--out", str(tmp_path), *TEACHER])
    assert not (tmp_path / "epoch0.bin").exists()


def test_check_recipe_reads_the_sidecar_only(tmp_path):
    """A JAX-written store (no recipe.json) is readable by the port's reader
    and refused for replay; meta.json is the same either way."""
    rng = np.random.default_rng(2)
    vals, idxs, seeds = _records(rng, 16, 3, 1000)
    _write(JaxWriter, tmp_path, vals, idxs, seeds, np.arange(16), use_native=False)
    LogitsReader(str(tmp_path), 0).read_batch(np.arange(16))
    with pytest.raises(ValueError, match="no recipe.json"):
        check_recipe(str(tmp_path), replay_recipe(Config()))


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    GOLDEN.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(GOLDEN, **jax_tinyvit21m_distill_golden())
    print(f"wrote {GOLDEN}")
