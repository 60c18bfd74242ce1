"""cream_tpu_torch's RetinaNet (`models/retinanet.py`: anchors, the coder,
the assigner, EfficientViTFPN, RetinaHead, the loss, the decode, the
factories; `train/detection.py`'s focal loss; the EfficientViT canvas) and
its weight bridge, against the JAX package's on shared seeded weights and
numpy-seeded inputs (fp32, on the CPU).

Weights: `seeded_state_dict` on the port's model, carried to JAX through
`zoo.load.retinanet_state_dict_from_jax` inverted (`jax_detector_variables`:
the bridge run on index-filled leaves, then each tensor put back with the
inverse layout change, the transposed convs unflipped). The live
comparisons run a narrow EfficientViT backbone (embed 48/48/64, depth
1/1/1) at canvas 128, where stage 0's 8x8 map pads to 7x7 windows, and the
neck at canvas 480, where a level is not twice the next. The full width
(`retinanet_efficientvit_m4`, canvas 512, B=2) is held on the card to the
record JAX wrote (`__main__`), tests/data/torch_port/
retinanet_efficientvit_m4_512_seed0.npz: per-level sums and a seeded
subset of rows of the cls and reg outputs, the decode at score_thr 0 with
each detection's anchor, and one train step's losses and per-tensor grad
norms (the step in float64: JAX's fp32 CPU grads sit up to ~1.5% off
float64 where train-mode BN's E[x^2] - E[x]^2 variance cancels). Regenerate
it with
    PYTHONPATH=.:tests python tests/test_torch_retinanet.py
"""
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cream_tpu.models import create_model as jax_create_model
from cream_tpu.models import retinanet as JR
from cream_tpu.models.efficientvit import EfficientViT as JaxEfficientViT
from cream_tpu.ops.detection import nms as jax_nms
from cream_tpu.train.detection import sigmoid_focal_loss as jax_focal
from cream_tpu_torch.cli.train_retinanet import synthetic_boxes
from cream_tpu_torch.models import create_model
from cream_tpu_torch.models import retinanet as R
from cream_tpu_torch.models.efficientvit import EfficientViT
from cream_tpu_torch.train.detection import sigmoid_focal_loss
from cream_tpu_torch.zoo.load import retinanet_state_dict_from_jax, seeded_state_dict
from torch_port_bridges import assert_bridge_inverts
from torch_threads import one_torch_thread_module  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
DATA = REPO / "tests" / "data" / "torch_port"
GOLDEN = DATA / "retinanet_efficientvit_m4_512_seed0.npz"
EVIT_GOLDEN = DATA / "efficientvit_m5_seed0.npz"
WEIGHT_SEED, INPUT_SEED, TARGET_SEED, ROWS_SEED = 0, 1, 2, 3
NARROW_BB = dict(embed_dim=(48, 48, 64), key_dim=(8, 8, 8), depth=(1, 1, 1),
                 num_heads=(3, 3, 4), window_size=(7, 7, 7), kernels=(7, 5, 3, 3))
NC, FPN, CANVAS, BATCH = 5, 16, 128, 2


def _np(t) -> np.ndarray:
    return t.detach().float().cpu().numpy().copy()


def jax_detector_variables(sd: dict, template, bridge) -> dict:
    """The port's state_dict (or grads keyed by param name, over the
    state_dict) in the JAX model's variable layout: `bridge` run on the
    template's leaves filled with their own index tells each port tensor's
    JAX leaf; the tensor goes back with the inverse of the bridge's layout
    change (conv OIHW -> HWIO, Dense (out, in) -> (in, out), a transposed
    conv unflipped, Mask R-CNN's first shared fc from NCHW rows to NHWC).
    Every JAX leaf must be reached."""
    leaves, treedef = jax.tree_util.tree_flatten(template)
    marked = jax.tree_util.tree_unflatten(
        treedef, [np.full(leaf.shape, i + 1, np.float32) for i, leaf in enumerate(leaves)])
    out = [None] * len(leaves)
    for name, t in bridge(marked).items():
        if name.endswith("num_batches_tracked"):
            continue
        i = int(t.numpy().flat[0]) - 1
        v = _np(sd[name])
        if ("extra_trans_convs" in name or "upsample" in name) and v.ndim == 4:
            v = v.transpose(2, 3, 0, 1)[::-1, ::-1]
        elif name.endswith("shared_fcs.0.weight"):
            o, c = v.shape[0], v.shape[1] // 49
            v = v.reshape(o, c, 7, 7).transpose(2, 3, 1, 0).reshape(49 * c, o)
        elif v.ndim == 4:
            v = v.transpose(2, 3, 1, 0)
        elif v.ndim == 2 and not name.endswith("attention_biases"):
            v = v.T
        assert out[i] is None and v.shape == tuple(leaves[i].shape), name
        out[i] = np.ascontiguousarray(v)
    missing = [i for i, v in enumerate(out) if v is None]
    assert not missing, f"{len(missing)} JAX leaves no port tensor reaches"
    return jax.tree_util.tree_unflatten(treedef, out)


def narrow_retinanet(canvas: int = CANVAS):
    """(port model with seeded weights, its state_dict, JAX model)."""
    m = R.RetinaNet(EfficientViT(num_classes=0, canvas=canvas, **NARROW_BB),
                    NARROW_BB["embed_dim"], canvas, NC, FPN).eval()
    sd = seeded_state_dict(m, WEIGHT_SEED)
    m.load_state_dict(sd)
    jm = JR.RetinaNet(backbone=JaxEfficientViT(num_classes=0, **NARROW_BB), num_classes=NC,
                      fpn_channels=FPN)
    return m, sd, jm


def images(seed: int, batch: int, canvas: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (batch, canvas, canvas, 3)).astype(np.float32)


def targets(seed: int, batch: int, canvas: int, num_classes: int, max_boxes: int):
    """The CLIs' synthetic boxes: (boxes (B, M, 4), labels, valid)."""
    boxes, labels, valid, _ = synthetic_boxes(np.random.default_rng(seed), batch, canvas,
                                              max_boxes, num_classes)
    return boxes, labels, valid


def grad_norm_errors(jax_grads, port_grads: dict, state: dict, template, bridge):
    """(per-leaf |JAX norm - port norm|, JAX norms) over the params."""
    ported = jax_detector_variables({**state, **port_grads}, template, bridge)["params"]
    a = np.asarray([np.linalg.norm(np.asarray(g)) for g in jax.tree_util.tree_leaves(jax_grads)])
    b = np.asarray([np.linalg.norm(g) for g in jax.tree_util.tree_leaves(ported)])
    return np.abs(a - b), a


def assert_grad_norms(jax_grads, port_grads, state, template, bridge):
    """Per-tensor grad norms within 1e-3 relative; grads that train-mode BN
    reduces to float noise (a per-channel constant before a BN: the biases
    of the last sandwich before each PatchMerging) at 1e-5 of the largest
    tensor's norm."""
    diff, ref = grad_norm_errors(jax_grads, port_grads, state, template, bridge)
    assert np.all(diff <= 1e-3 * ref + 1e-5 * ref.max()), (diff / ref).max()


@pytest.fixture(scope="module")
def narrow():
    """The narrow model at canvas 128, JAX's eval outputs, its train-step
    loss and grads on synthetic targets."""
    torch.set_num_threads(1)
    m, sd, jm = narrow_retinanet()
    x = images(INPUT_SEED, BATCH, CANVAS)
    template = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.asarray(x)))
    v = jax_detector_variables(sd, template, retinanet_state_dict_from_jax)
    cls, reg = jax.jit(jm.apply)(v, jnp.asarray(x))
    anchors = R.retina_anchors(CANVAS)
    gt = targets(TARGET_SEED, BATCH, CANVAS, NC, 6)

    def loss_fn(p, stats):
        (c, r), mut = jm.apply({"params": p, "batch_stats": stats}, jnp.asarray(x), train=True,
                               mutable=["batch_stats"])
        losses = JR.retinanet_loss(c, r, jnp.asarray(anchors), *map(jnp.asarray, gt), NC)
        return losses["loss_cls"] + losses["loss_bbox"], (losses, mut)
    (loss, (losses, mut)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        v["params"], v["batch_stats"])
    return dict(m=m, sd=sd, jm=jm, x=x, v=v, template=template, cls=np.asarray(cls),
                reg=np.asarray(reg), anchors=anchors, gt=gt, loss=float(loss),
                losses={k: float(t) for k, t in losses.items()}, grads=grads, stats=mut)


# ---------------------------------------------------------------- anchors etc.

@pytest.mark.parametrize("canvas", [128, 480, 512])
def test_anchors_bit_for_bit(canvas):
    got = R.retina_anchors(canvas)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, JR.retina_anchors(canvas))
    assert R.anchors_per_level(canvas) == JR.anchors_per_level(canvas)
    assert sum(R.anchors_per_level(canvas)) == len(got)


def test_coder_matches_jax():
    rng = np.random.default_rng(0)
    xy = rng.uniform(0, 400, (500, 2)).astype(np.float32)
    a = np.concatenate([xy, xy + rng.uniform(1, 200, (500, 2)).astype(np.float32)], 1)
    g = np.concatenate([xy + 3, xy + rng.uniform(1, 200, (500, 2)).astype(np.float32)], 1)
    d = rng.normal(0, 1.5, (500, 4)).astype(np.float32)          # some past the dw/dh clip
    # the same fp32 ops; log and exp from other libraries (XLA's vs ATen's):
    # 2 ulps of the coordinates at most
    np.testing.assert_allclose(_np(R.bbox2delta(torch.from_numpy(a), torch.from_numpy(g))),
                               np.asarray(JR.bbox2delta(a, g)), rtol=3e-7, atol=3e-7)
    for shape in (None, (300, 400)):
        np.testing.assert_allclose(
            _np(R.delta2bbox(torch.from_numpy(a), torch.from_numpy(d), shape)),
            np.asarray(JR.delta2bbox(a, d, shape)), rtol=3e-7, atol=1e-4)


@pytest.mark.parametrize("thr", [(0.5, 0.4, 0.0), (0.7, 0.3, 0.3), (0.5, 0.5, 0.5)])
def test_assigner_bit_for_bit(thr):
    anchors = R.retina_anchors(128)
    boxes, labels, valid = targets(4, 3, 128, NC, 8)
    valid[2] = False                                    # an image without boxes: all ignored
    boxes[0, 1] = boxes[0, 0]                           # a duplicate gt: the later one wins
    want = np.stack([np.asarray(JR.max_iou_assign(anchors, boxes[b], valid[b], *thr))
                     for b in range(3)])
    got = R.max_iou_assign(torch.from_numpy(anchors), torch.from_numpy(boxes),
                           torch.from_numpy(valid), *thr).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got >= 0).any() and (got == -1).any() and (got[2] == -2).all()


def test_jax_assigner_ignores_an_image_without_gts():
    """JAX gives invalid gts IoU -1, so an image with none leaves every
    anchor in the ignore band (-2): no negatives, no focal loss from it
    (mmdet 2.x would assign background). The port follows (ROADMAP Queue
    3)."""
    anchors = R.retina_anchors(64)
    boxes, labels, valid = targets(6, 2, 64, NC, 4)
    valid[1] = False
    want = np.asarray(JR.max_iou_assign(anchors, boxes[1], valid[1]))
    got = R.max_iou_assign(torch.from_numpy(anchors), torch.from_numpy(boxes),
                           torch.from_numpy(valid)).numpy()
    assert (want == -2).all() and (got[1] == -2).all() and (got[0] != -2).any()
    cls = torch.zeros(2, len(anchors), NC)
    losses = R.retinanet_loss(cls, torch.zeros(2, len(anchors), 4), torch.from_numpy(anchors),
                              torch.from_numpy(boxes), torch.from_numpy(labels),
                              torch.from_numpy(valid))
    one = R.retinanet_loss(cls[:1], torch.zeros(1, len(anchors), 4), torch.from_numpy(anchors),
                           torch.from_numpy(boxes[:1]), torch.from_numpy(labels[:1]),
                           torch.from_numpy(valid[:1]))
    # the empty image adds 0 to the batch mean's sum
    assert abs(float(losses["loss_cls"]) - float(one["loss_cls"]) / 2) <= 1e-6 * float(
        one["loss_cls"])


def test_sigmoid_focal_loss_matches_jax():
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((64, 7)) * 30).astype(np.float32)    # past exp's overflow
    t = rng.integers(-1, 8, 64).astype(np.int32)
    want, vjp = jax.vjp(lambda z: jax_focal(z, jnp.asarray(t)), jnp.asarray(logits))
    w = rng.standard_normal((64, 7)).astype(np.float32)
    z = torch.from_numpy(logits).requires_grad_()
    got = sigmoid_focal_loss(z, torch.from_numpy(t))
    (got * torch.from_numpy(w)).sum().backward()
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(z.grad), np.asarray(vjp(jnp.asarray(w))[0]), rtol=1e-5,
                               atol=1e-6)


# ------------------------------------------------------------------ modules

def test_conv_transpose_flip():
    """flax ConvTranspose(2, 2, SAME) == torch ConvTranspose2d with the
    kernel flipped in both spatial axes, which the bridge does."""
    import flax.linen as fnn
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 7, 6)).astype(np.float32)
    layer = fnn.ConvTranspose(4, (2, 2), strides=(2, 2))
    v = layer.init(jax.random.key(0), jnp.asarray(x))
    want = np.asarray(layer.apply(v, jnp.asarray(x)))
    conv = torch.nn.ConvTranspose2d(6, 4, 2, 2)
    from cream_tpu_torch.zoo.load import _conv_transpose
    conv.weight.data = torch.from_numpy(_conv_transpose(v["params"]["kernel"]))
    conv.bias.data = torch.from_numpy(np.asarray(v["params"]["bias"]))
    got = R.conv_transpose_nhwc(conv, torch.from_numpy(x), torch.float32)
    assert got.shape == (2, 10, 14, 4)
    np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("canvas,extra", [(128, 1), (480, 1), (480, 2)])
def test_fpn_matches_jax(canvas, extra):
    """The neck alone on the stage maps of a canvas: at 480 the stride-64
    map is 8x8 and the stride-32 one 15x15 (the nearest resize is not a
    doubling there)."""
    sizes = [canvas // 16, -(-canvas // 32), -(-canvas // 64)]
    rng = np.random.default_rng(canvas + extra)
    feats = [rng.standard_normal((2, s, s, c)).astype(np.float32)
             for s, c in zip(sizes, (12, 20, 24))]
    neck = R.EfficientViTFPN((12, 20, 24), 8, extra)
    sd = seeded_state_dict(neck, 1)
    neck.load_state_dict(sd)
    jneck = JR.EfficientViTFPN(8, num_extra_trans_convs=extra)
    template = jax.eval_shape(
        lambda: jneck.init(jax.random.key(0), [jnp.asarray(f) for f in feats]))

    def bridge(variables):
        from cream_tpu_torch.zoo.load import _fpn_from_jax, _Writer
        w = _Writer({"params": {"neck": variables["params"]}})
        _fpn_from_jax(w, "neck", "neck")
        return {k[len("neck."):]: v for k, v in w.state_dict().items()}
    v = jax_detector_variables(sd, template, bridge)
    want = jneck.apply(v, [jnp.asarray(f) for f in feats])
    with torch.no_grad():
        got = neck([torch.from_numpy(f) for f in feats])
    assert [tuple(t.shape) for t in got] == [tuple(w.shape) for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-5, atol=1e-5)


def test_forward_matches_jax(narrow):
    """Eval forward at canvas 128 (stage 0's 8x8 map padded to 7x7 windows,
    then 4x4 and 2x2): fp32 sums in other orders, 1e-5 of the largest."""
    with torch.no_grad():
        cls, reg = narrow["m"](torch.from_numpy(narrow["x"]))
    assert cls.shape == narrow["cls"].shape == (BATCH, sum(R.anchors_per_level(CANVAS)), NC)
    for got, want in ((cls, narrow["cls"]), (reg, narrow["reg"])):
        np.testing.assert_allclose(_np(got), want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_decode_matches_jax(narrow):
    """The decode at score_thr 0 on the JAX outputs (300 candidates a
    level, 789 in all): the same detections (labels, boxes within 1e-4
    px, scores within 1e-6)."""
    cls, reg, anchors = narrow["cls"], narrow["reg"], narrow["anchors"]
    levels = R.anchors_per_level(CANVAS)
    want = JR.retinanet_decode(jnp.asarray(cls), jnp.asarray(reg), jnp.asarray(anchors), levels,
                               score_thr=0.0, nms_pre=300)
    got = R.retinanet_decode(torch.from_numpy(cls), torch.from_numpy(reg),
                             torch.from_numpy(anchors), levels, score_thr=0.0, nms_pre=300)
    anchors_of = jax_decode_with_anchors(cls, reg, jnp.asarray(anchors), levels, nms_pre=300)
    for g, w, a in zip(got, want, anchors_of):
        assert len(g["scores"]) == len(w["scores"]) == 100
        np.testing.assert_array_equal(g["labels"], w["labels"])
        np.testing.assert_array_equal(g["anchor"], a["anchor"])
        np.testing.assert_allclose(g["scores"], w["scores"], rtol=0, atol=1e-6)
        np.testing.assert_allclose(g["boxes"], w["boxes"], rtol=0, atol=1e-4)


def test_decode_ties_follow_lax_top_k():
    """Equal scores (common in bf16) rank the lower anchor first, as
    lax.top_k does, so the detections are a function of the scores."""
    rng = np.random.default_rng(5)
    levels = R.anchors_per_level(64)
    A = sum(levels)
    cls = np.round(rng.standard_normal((1, A, 3)) * 2) / 2          # many exact ties
    reg = (rng.standard_normal((1, A, 4)) * 0.1).astype(np.float32)
    anchors = R.retina_anchors(64)
    want = JR.retinanet_decode(jnp.asarray(cls, jnp.float32), jnp.asarray(reg),
                               jnp.asarray(anchors), levels, nms_pre=50)
    got = R.retinanet_decode(torch.tensor(cls, dtype=torch.float32), torch.from_numpy(reg),
                             torch.from_numpy(anchors), levels, nms_pre=50)
    np.testing.assert_array_equal(got[0]["labels"], want[0]["labels"])
    np.testing.assert_allclose(got[0]["boxes"], want[0]["boxes"], rtol=0, atol=1e-4)


def test_train_step_matches_jax(narrow):
    """One train-mode step at canvas 128 (padded windows: the padded tokens
    enter the attention BNs' batch statistics): the losses within 1e-4, the
    positive count equal, per-tensor grad norms within 1e-3."""
    m = narrow["m"]
    m.load_state_dict(narrow["sd"])
    m.train()
    cls, reg = m(torch.from_numpy(narrow["x"]))
    losses = R.retinanet_loss(cls, reg, torch.from_numpy(narrow["anchors"]),
                              *map(torch.from_numpy, narrow["gt"]), NC)
    total = losses["loss_cls"] + losses["loss_bbox"]
    params = dict(m.named_parameters())
    grads = dict(zip(params, torch.autograd.grad(total, list(params.values()))))
    m.eval()
    assert int(losses["num_pos"]) == int(narrow["losses"]["num_pos"]) > 0
    for k in ("loss_cls", "loss_bbox"):
        assert abs(float(losses[k]) - narrow["losses"][k]) <= 1e-4 * abs(narrow["losses"][k])
    assert abs(float(total) - narrow["loss"]) <= 1e-4 * narrow["loss"]
    state = {k: t.detach() for k, t in m.state_dict().items()}
    assert_grad_norms(narrow["grads"], grads, state, narrow["template"],
                      retinanet_state_dict_from_jax)
    # the BN running stats the step moved, the attention BNs' among them
    jstats = jax_detector_variables(state, narrow["template"],
                                    retinanet_state_dict_from_jax)["batch_stats"]
    for a, b in zip(jax.tree_util.tree_leaves(narrow["stats"]["batch_stats"]),
                    jax.tree_util.tree_leaves(jstats)):
        np.testing.assert_allclose(b, np.asarray(a), rtol=1e-4, atol=1e-5)


def test_bridge_reaches_every_leaf_and_inverts(narrow):
    assert_bridge_inverts(narrow["sd"], narrow["v"], retinanet_state_dict_from_jax)
    names = set(narrow["sd"])
    assert {"neck.lateral_convs.0.conv.weight", "neck.extra_trans_convs.0.weight",
            "neck.extra_fpn_convs.0.conv.bias", "bbox_head.cls_convs.3.conv.weight",
            "bbox_head.retina_cls.bias", "bbox_head.retina_reg.weight",
            "backbone.blocks1.0.mixer.m.attn.attention_biases"} <= names


# ---------------------------------------------------------------- backbone

@pytest.mark.parametrize("canvas,windows", [(128, (7, 4, 2)), (512, (7, 7, 4)), (224, (7, 7, 4))])
def test_backbone_windows_follow_the_canvas(canvas, windows):
    """JAX picks each stage's window at call time, min(7, the 224 stage
    resolution, the map); the port builds it from the canvas, bias tables
    included."""
    from cream_tpu_torch.models.efficientvit import LocalWindowAttention
    m = R.efficientvit_backbone("efficientvit_m4", canvas, dtype=torch.float32, device="meta")
    got = []
    for blocks in (m.blocks1, m.blocks2, m.blocks3):
        got.append({mod.window for mod in blocks.modules()
                    if isinstance(mod, LocalWindowAttention)}.pop())
    assert tuple(got) == windows


def test_classification_at_224_unchanged():
    """EfficientViT-M5 at 224 still gives its stored JAX logits (the canvas
    change builds the classifier as before)."""
    g = np.load(EVIT_GOLDEN)
    m = create_model("efficientvit_m5", device="cpu")
    assert m.input_size == m.img_size == 224
    m.load_state_dict(seeded_state_dict(m, int(g["weight_seed"])))
    x = images(int(g["input_seed"]), 2, 224)
    with torch.no_grad():
        got = m(torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), g["logits"], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name,kw", [("retinanet_cream", dict(arch="cream_14")),
                                     ("retinanet_efficientvit_m0", {})])
def test_factories_build_p3_to_p7(name, kw):
    """Every factory gives P3-P7 (RETINA_STRIDES) at a canvas; the NAS
    backbones drop their classifiers (a detector never runs them)."""
    m = create_model(name, num_classes=3, canvas=64, device="cpu", **kw)
    m.load_state_dict(seeded_state_dict(m, 0))
    with torch.no_grad():
        feats = m.features(torch.from_numpy(images(0, 1, 64)))
        cls, reg = m(torch.from_numpy(images(0, 1, 64)))
    assert [f.shape[1] for f in feats] == [-(-64 // s) for s in R.RETINA_STRIDES]
    assert cls.shape == (1, sum(R.anchors_per_level(64)), 3) and reg.shape[-1] == 4
    assert not any(k.startswith(("backbone.classifier", "backbone.conv_head"))
                   for k in m.state_dict())


def test_golden_file_layout():
    """The full-width record the card holds the port to."""
    g = np.load(GOLDEN)
    A = sum(R.anchors_per_level(int(g["canvas"])))
    assert int(g["canvas"]) == 512 and int(g["batch"]) == 2 and A == 49104
    assert g["rows"].shape == (128,) and g["cls_rows"].shape == (2, 128, 80)
    assert g["cls_level_sums"].shape == (2, 5) and g["reg_level_sums"].shape == (2, 5, 4)
    assert g["det_anchor"].shape == (2, 100) and (g["det_anchor"] < A).all()
    assert len(g["names"]) == len(g["grad_norms"]) and np.isfinite(g["loss"])
    m = create_model("retinanet_efficientvit_m4", device="meta")
    assert sorted(n for n, _ in m.named_parameters()) == list(g["names"])


# ----------------------------------------------------------- golden writer

def jax_decode_with_anchors(cls, reg, anchors, level_sizes, nms_pre=1000, iou_thr=0.5,
                            max_per_img=100):
    """The JAX package's `retinanet_decode` at score_thr 0, step for step,
    also returning each detection's anchor index."""
    probs = jax.nn.sigmoid(jnp.asarray(cls, jnp.float32))
    reg = jnp.asarray(reg)
    out = []
    for b in range(cls.shape[0]):
        boxes_l, scores_l, labels_l, ids_l = [], [], [], []
        off = 0
        for n in level_sizes:
            p, d, a = probs[b, off:off + n], reg[b, off:off + n], anchors[off:off + n]
            _, idx = jax.lax.top_k(p.max(axis=1), min(nms_pre, n))
            boxes_l.append(JR.delta2bbox(a[idx], d[idx]))
            scores_l.append(p[idx].max(axis=1))
            labels_l.append(p[idx].argmax(axis=1))
            ids_l.append(idx + off)
            off += n
        boxes, scores = jnp.concatenate(boxes_l), jnp.concatenate(scores_l)
        labels, ids = jnp.concatenate(labels_l), jnp.concatenate(ids_l)
        offset = labels.astype(jnp.float32)[:, None] * 1e5
        keep, valid = jax_nms(boxes + offset, scores, iou_thr, max_outputs=max_per_img)
        k = np.asarray(keep)[np.asarray(valid)]
        out.append({"boxes": np.asarray(boxes)[k], "scores": np.asarray(scores)[k],
                    "labels": np.asarray(labels)[k], "anchor": np.asarray(ids)[k]})
    return out


def level_sums(t: np.ndarray, level_sizes) -> np.ndarray:
    """(B, A, ...) -> per-level sums over the level's anchors and classes
    (B, L) for cls, (B, L, 4) for reg."""
    out, off = [], 0
    for n in level_sizes:
        part = t[:, off:off + n].astype(np.float64)
        out.append(part.sum(axis=(1, 2)) if t.shape[-1] != 4 else part.sum(axis=1))
        off += n
    return np.stack(out, axis=1)


def write_golden(path: Path = GOLDEN, canvas: int = 512, batch: int = 2) -> None:
    """JAX's RetinaNet-M4 at `canvas` on the port's seeded weights: the
    outputs and decode in fp32, the train step in float64."""
    name = "retinanet_efficientvit_m4"
    port = create_model(name, canvas=canvas, device="cpu")
    sd = seeded_state_dict(port, WEIGHT_SEED)
    jm = jax_create_model(name)
    x = images(INPUT_SEED, batch, canvas)
    template = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.asarray(x)))
    v = jax_detector_variables(sd, template, retinanet_state_dict_from_jax)
    cls, reg = (np.asarray(t) for t in jax.jit(jm.apply)(v, jnp.asarray(x)))
    levels = JR.anchors_per_level(canvas)
    anchors = JR.retina_anchors(canvas)
    rows = np.sort(np.random.default_rng(ROWS_SEED).choice(len(anchors), 128, replace=False))
    dets = jax_decode_with_anchors(cls, reg, jnp.asarray(anchors), levels)
    gt = targets(TARGET_SEED, batch, canvas, 80, 32)
    # the train step in float64: JAX's fp32 CPU grads sit up to ~1.5% off
    # float64 at the train-mode BN's variance (E[x^2] - E[x]^2)
    jax.config.update("jax_enable_x64", True)
    jm = jax_create_model(name, dtype=jnp.float64)
    v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), v)

    def loss_fn(p, stats):
        (c, r), _ = jm.apply({"params": p, "batch_stats": stats}, jnp.asarray(x, jnp.float64),
                             train=True, mutable=["batch_stats"])
        losses = JR.retinanet_loss(c, r, jnp.asarray(anchors), *map(jnp.asarray, gt), 80)
        return losses["loss_cls"] + losses["loss_bbox"], losses
    (loss, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        v["params"], v["batch_stats"])
    jax.config.update("jax_enable_x64", False)
    named = retinanet_state_dict_from_jax({"params": grads, "batch_stats": v["batch_stats"]})
    names = sorted(n for n, _ in port.named_parameters())
    stack = lambda k: np.stack([d[k][:100] for d in dets])  # noqa: E731
    np.savez_compressed(
        path, weight_seed=WEIGHT_SEED, input_seed=INPUT_SEED, target_seed=TARGET_SEED,
        canvas=canvas, batch=batch, rows=rows, cls_rows=cls[:, rows], reg_rows=reg[:, rows],
        cls_level_sums=level_sums(cls, levels), reg_level_sums=level_sums(reg, levels),
        det_boxes=stack("boxes"), det_scores=stack("scores"), det_labels=stack("labels"),
        det_anchor=stack("anchor"), loss=float(loss), loss_cls=float(losses["loss_cls"]),
        loss_bbox=float(losses["loss_bbox"]), num_pos=int(losses["num_pos"]),
        names=np.asarray(names),
        grad_norms=np.asarray([np.linalg.norm(named[n].numpy()) for n in names], np.float32),
        grad_norm=float(np.sqrt(sum(np.sum(np.square(np.asarray(g), dtype=np.float64))
                                    for g in jax.tree_util.tree_leaves(grads)))))
    print(f"wrote {path} ({path.stat().st_size} bytes), loss {float(loss):.6f}")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    write_golden()
