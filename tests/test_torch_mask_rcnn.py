"""cream_tpu_torch's Mask R-CNN (`models/mask_rcnn.py`: the anchors, the
multi-level RoIAlign, the RandomSampler, the RPN loss and proposals, the
RCNN stage and losses, the mask loss, the decode, the whole two-stage
train loss) and its weight bridge, against the JAX package's on shared
seeded weights and numpy-seeded inputs (fp32, on the CPU).

The port's samplers take their uniforms as arguments; every comparison
feeds them JAX's draws (`jax_draws`: the JAX CLI's key splits), so the
sampled anchors and rois are JAX's. Weights go to JAX through
`zoo.load.mask_rcnn_state_dict_from_jax` inverted
(`test_torch_retinanet.jax_detector_variables`). The live model runs a
narrow EfficientViT backbone (embed 48/48/64) with narrow heads at canvas
128 (padded windows). The full width (`mask_rcnn_efficientvit_m4`, canvas
512, B=2) is held on the card to the record JAX wrote (`__main__`),
tests/data/torch_port/mask_rcnn_efficientvit_m4_512_seed0.npz: the RPN
outputs' per-level sums and seeded rows, the proposals, the box head on
JAX's proposals, the decode and the mask head's sums on its detections,
and one train step's five losses and per-tensor grad norms (the step in
float64, as JAX's fp32 CPU grads sit up to ~1.5% off it) with the sampled
order of JAX's fp32 draws (each sampler call's top-k indices and their
uniforms: `uniforms_from_top` rebuilds priorities that sample the same).
Regenerate it with
    PYTHONPATH=.:tests python tests/test_torch_mask_rcnn.py
"""
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cream_tpu.models import create_model as jax_create_model
from cream_tpu.models import mask_rcnn as JM
from cream_tpu.models.efficientvit import EfficientViT as JaxEfficientViT
from cream_tpu_torch.cli.train_mask_rcnn import synthetic_targets
from cream_tpu_torch.models import create_model
from cream_tpu_torch.models import mask_rcnn as M
from cream_tpu_torch.models.efficientvit import EfficientViT
from cream_tpu_torch.ops.detection import roi_levels
from cream_tpu_torch.zoo.load import mask_rcnn_state_dict_from_jax, seeded_state_dict
from torch_port_bridges import assert_bridge_inverts

from test_torch_retinanet import (NARROW_BB, _np, assert_grad_norms, images,
                                  jax_detector_variables)
from torch_threads import one_torch_thread_module  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "data" / "torch_port" / "mask_rcnn_efficientvit_m4_512_seed0.npz"
WEIGHT_SEED, INPUT_SEED, TARGET_SEED, ROWS_SEED, KEY_SEED = 0, 1, 2, 3, 7
NC, FPN, FC, MASK_C, CANVAS, BATCH = 5, 16, 32, 16, 128, 2
RPN_S, RCNN_S, PROPS = 64, 32, 48                 # the narrow step's sampler sizes
bridge = mask_rcnn_state_dict_from_jax


class NarrowJaxMaskRCNN(JM.MaskRCNN):
    """The JAX MaskRCNN with narrow box and mask heads (its own setup
    fixes them at 1024 and 256)."""

    def setup(self):
        self.neck = JM.EfficientViTFPN(self.fpn_channels, num_extra_trans_convs=2)
        self.rpn_head = JM.RPNHead(self.fpn_channels)
        self.bbox_head = JM.BBoxHead(self.num_classes, fc_channels=FC)
        self.mask_head = JM.MaskHead(self.num_classes, conv_channels=MASK_C)


def key_draws(key, n: int) -> np.ndarray:
    """(2, n): the (pos, neg) uniforms JAX's `random_sample(key, ...)` draws
    (r1, r2 = split(key))."""
    r1, r2 = jax.random.split(key)
    return np.asarray([jax.random.uniform(r1, (n,)), jax.random.uniform(r2, (n,))], np.float32)


def jax_draws(key, batch: int, n: int) -> np.ndarray:
    """(B, 2, n): each image's draws as the JAX losses take them (`key`
    split over the batch)."""
    return np.stack([key_draws(k, n) for k in jax.random.split(key, batch)])


def uniforms_from_top(idx: np.ndarray, u: np.ndarray, n: int) -> np.ndarray:
    """Priorities (..., n) that sample as the draws whose top-k indices
    `idx` (..., k) and values `u` a golden stores: those values at those
    indices, a tiny positive value elsewhere (below every stored one)."""
    out = np.full(idx.shape[:-1] + (n,), 1e-30, np.float32)
    np.put_along_axis(out, idx, u, axis=-1)
    return out


def top_of_draws(u: np.ndarray, mask: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """The top-k indices of where(mask, u, -1) (lax.top_k's order) and the
    draws there: what `uniforms_from_top` needs to sample the same."""
    _, idx = jax.lax.top_k(jnp.where(jnp.asarray(mask), jnp.asarray(u), -1.0), k)
    idx = np.asarray(idx)
    return idx, np.take_along_axis(u, idx, axis=-1)


def narrow_model():
    m = M.MaskRCNN(EfficientViT(num_classes=0, canvas=CANVAS, **NARROW_BB),
                   NARROW_BB["embed_dim"], CANVAS, NC, FPN, FC, MASK_C).eval()
    sd = seeded_state_dict(m, WEIGHT_SEED)
    m.load_state_dict(sd)
    jm = NarrowJaxMaskRCNN(backbone=JaxEfficientViT(num_classes=0, **NARROW_BB),
                           num_classes=NC, fpn_channels=FPN)
    return m, sd, jm


def jax_rois_flat(rois_b):
    B, R, _ = rois_b.shape
    bi = jnp.repeat(jnp.arange(B, dtype=jnp.float32), R)[:, None]
    return jnp.concatenate([bi, rois_b.reshape(B * R, 4)], axis=1)


def jax_step_loss(jm, x, tgt, anchors, levels, key, canvas, num_classes, rpn_s, rcnn_s,
                  props_n):
    """The JAX CLI's Mask R-CNN train loss (cli/train_mask_rcnn.py's
    loss_fn) as a function of (params, stats): (total, (losses, proposals,
    their scores))."""
    pos_cap = max(int(rcnn_s * 0.25), 1)
    gt, lab, val, masks = (jnp.asarray(tgt[k]) for k in ("boxes", "labels", "valid", "masks"))

    def loss_fn(p, stats):
        r_rpn, r_rcnn = jax.random.split(key)
        variables = {"params": p, "batch_stats": stats}
        feats, _ = jm.apply(variables, jnp.asarray(x), True, method=JM.MaskRCNN.features,
                            mutable=["batch_stats"])
        rpn_cls, rpn_reg = jm.apply(variables, feats, method=JM.MaskRCNN.rpn)
        l_rpn_cls, l_rpn_reg = JM.rpn_loss(rpn_cls, rpn_reg, jnp.asarray(anchors), gt, val,
                                           r_rpn, num_samples=rpn_s)
        props, pscore = JM.rpn_proposals(jax.lax.stop_gradient(rpn_cls),
                                         jax.lax.stop_gradient(rpn_reg), jnp.asarray(anchors),
                                         levels, canvas, max_per_img=props_n)
        B = props.shape[0]
        t = jax.vmap(lambda k, pr, pv, g, l, v: JM.rcnn_stage(k, pr, pv, g, l, v, num_classes,
                                                              num=rcnn_s))(
            jax.random.split(r_rcnn, B), props, pscore > 0, gt, lab, val)
        cls, reg = jm.apply(variables, feats, jax_rois_flat(t["rois"]),
                            method=JM.MaskRCNN.roi_bbox)
        flat = jax.tree_util.tree_map(lambda a: a.reshape((-1,) + a.shape[2:]), t)
        l_cls, l_reg = JM.rcnn_loss(cls, reg, flat)
        ml = jm.apply(variables, feats, jax_rois_flat(t["rois"][:, :pos_cap]),
                      method=JM.MaskRCNN.roi_mask)
        Mm, C = ml.shape[1], ml.shape[-1]
        l_mask = jax.vmap(JM.mask_loss)(ml.reshape(B, pos_cap, Mm, Mm, C),
                                        t["rois"][:, :pos_cap], t["assigned_gt"][:, :pos_cap],
                                        t["labels"][:, :pos_cap], t["pos"][:, :pos_cap],
                                        masks).mean()
        losses = {"rpn_cls": l_rpn_cls, "rpn_reg": l_rpn_reg, "cls": l_cls, "reg": l_reg,
                  "mask": l_mask, "num_pos": t["pos"].sum()}
        return l_rpn_cls + l_rpn_reg + l_cls + l_reg + l_mask, (losses, props, pscore)
    return loss_fn


@pytest.fixture(scope="module")
def narrow():
    torch.set_num_threads(1)
    m, sd, jm = narrow_model()
    x = images(INPUT_SEED, BATCH, CANVAS)
    template = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.asarray(x)))
    v = jax_detector_variables(sd, template, bridge)
    anchors = M.mask_rcnn_anchors(CANVAS)
    levels = M.mask_rcnn_anchor_levels(CANVAS)
    tgt = synthetic_targets(np.random.default_rng(TARGET_SEED), BATCH, CANVAS, 6, NC)
    key = jax.random.key(KEY_SEED)
    loss_fn = jax_step_loss(jm, x, tgt, anchors, levels, key, CANVAS, NC, RPN_S, RCNN_S, PROPS)
    (loss, (losses, props, pscore)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        v["params"], v["batch_stats"])
    r_rpn, r_rcnn = jax.random.split(key)
    return dict(m=m, sd=sd, jm=jm, x=x, v=v, template=template, anchors=anchors, levels=levels,
                tgt=tgt, loss=float(loss), losses={k: float(t) for k, t in losses.items()},
                grads=grads, props=np.asarray(props),
                u_rpn=jax_draws(r_rpn, BATCH, len(anchors)),
                u_rcnn=jax_draws(r_rcnn, BATCH, 6 + PROPS))


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("canvas", [128, 512])
def test_anchors_bit_for_bit(canvas):
    np.testing.assert_array_equal(M.mask_rcnn_anchors(canvas), JM.mask_rcnn_anchors(canvas))
    assert M.mask_rcnn_anchor_levels(canvas) == JM.mask_rcnn_anchor_levels(canvas)


def _level_feats(seed: int, canvas: int = 128, c: int = 6):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((2, canvas // s, canvas // s, c)).astype(np.float32)
            for s in M.MRCNN_STRIDES]


def _rois(seed: int, n: int, canvas: int = 128) -> np.ndarray:
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-10, canvas, (n, 2))
    wh = np.exp(rng.uniform(np.log(4), np.log(1200), (n, 2)))
    return np.concatenate([rng.integers(0, 2, (n, 1)), xy, xy + wh], 1).astype(np.float32)


def test_multilevel_roi_align_and_grad_match_jax():
    """Each roi aligned on its own level only, against JAX's dense
    every-level-and-mask form; the features' grads against jax.vjp. Rois
    span every level and leave the map."""
    feats = _level_feats(0)
    rois = _rois(1, 40)
    want, vjp = jax.vjp(lambda *f: JM.multilevel_roi_align(f, jnp.asarray(rois), 7),
                        *map(jnp.asarray, feats))
    assert len(set(roi_levels(_t(rois), 4).tolist())) == 4
    ft = [_t(f).requires_grad_() for f in feats]
    got = M.multilevel_roi_align(ft, _t(rois), 7)
    w = np.random.default_rng(2).standard_normal(got.shape).astype(np.float32)
    (got * _t(w)).sum().backward()
    # the sample points' fp32 products in other roundings (XLA contracts
    # a + b*c): up to ~5e-6 on O(1) features
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=1e-5)
    for g, jg in zip(ft[:4], vjp(jnp.asarray(w))[:4]):
        np.testing.assert_allclose(_np(g.grad), np.asarray(jg), rtol=1e-5, atol=1e-5)
    assert ft[4].grad is None                       # the stride-64 level feeds no roi


@pytest.mark.parametrize("n,num,frac,p_pos", [(500, 64, 0.5, 0.05), (300, 32, 0.25, 0.5),
                                              (20, 32, 0.25, 0.3), (200, 64, 0.5, 0.0)])
def test_random_sample_with_jax_draws(n, num, frac, p_pos):
    """The same indices, positives and validity as JAX's sampler fed its own
    draws: scarce and plentiful positives, fewer candidates than samples
    (padding), none."""
    rng = np.random.default_rng(n + num)
    pos = rng.random((3, n)) < p_pos
    neg = ~pos & (rng.random((3, n)) < 0.7)
    keys = jax.random.split(jax.random.key(n), 3)
    want = [JM.random_sample(k, jnp.asarray(p), jnp.asarray(q), num, frac)
            for k, p, q in zip(keys, pos, neg)]
    u = np.stack([key_draws(k, n) for k in keys])
    got = M.random_sample(_t(pos), _t(neg), num, frac, _t(u[:, 0]), _t(u[:, 1]))
    for j, name in enumerate(("idx", "is_pos", "valid")):
        np.testing.assert_array_equal(got[j].numpy(), np.stack([np.asarray(w[j]) for w in want]),
                                      err_msg=name)
    # the golden's compressed draws sample the same
    cap, neg_k = min(int(num * frac), n), min(num, n)
    ip, up = top_of_draws(u[:, 0], pos, cap)
    ineg, uneg = top_of_draws(u[:, 1], neg, neg_k)
    again = M.random_sample(_t(pos), _t(neg), num, frac, _t(uniforms_from_top(ip, up, n)),
                            _t(uniforms_from_top(ineg, uneg, n)))
    for a, b in zip(again, got):
        assert torch.equal(a, b)


def _rpn_inputs(seed: int, canvas: int = 128):
    rng = np.random.default_rng(seed)
    A = len(M.mask_rcnn_anchors(canvas))
    cls = rng.standard_normal((2, A)).astype(np.float32) * 2
    reg = rng.standard_normal((2, A, 4)).astype(np.float32) * 0.3
    return cls, reg


def test_rpn_loss_with_jax_draws():
    anchors = M.mask_rcnn_anchors(64)
    cls, reg = _rpn_inputs(3, 64)
    tgt = synthetic_targets(np.random.default_rng(4), 2, 64, 6, NC)
    key = jax.random.key(5)
    want = JM.rpn_loss(jnp.asarray(cls), jnp.asarray(reg), jnp.asarray(anchors),
                       jnp.asarray(tgt["boxes"]), jnp.asarray(tgt["valid"]), key, 64)
    got = M.rpn_loss(_t(cls), _t(reg), _t(anchors), _t(tgt["boxes"]), _t(tgt["valid"]),
                     _t(jax_draws(key, 2, len(anchors))), 64)
    for g, w in zip(got, want):
        assert abs(float(g) - float(w)) <= 1e-6 * abs(float(w))


def test_rpn_proposals_match_jax():
    """Per-level top-k on the logits, the clipped decode and one NMS at .7:
    the same proposals (1e-4 px) and scores."""
    anchors, levels = M.mask_rcnn_anchors(64), M.mask_rcnn_anchor_levels(64)
    cls, reg = _rpn_inputs(6, 64)
    cls = np.round(cls * 4) / 4                             # ties in the top-k
    want = JM.rpn_proposals(jnp.asarray(cls), jnp.asarray(reg), jnp.asarray(anchors), levels,
                            64, nms_pre=100, max_per_img=64)
    got = M.rpn_proposals(_t(cls), _t(reg), _t(anchors), levels, 64, nms_pre=100,
                          max_per_img=64)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0, atol=1e-7)


def test_rcnn_stage_and_losses_with_jax_draws():
    rng = np.random.default_rng(8)
    tgt = synthetic_targets(rng, 2, 128, 6, NC)
    props = np.concatenate([tgt["boxes"] + rng.normal(0, 4, tgt["boxes"].shape),
                            tgt["boxes"][:, ::-1] + rng.normal(0, 20, tgt["boxes"].shape)], 1)
    props = np.clip(np.sort(props.reshape(2, -1, 2, 2), axis=2).reshape(2, -1, 4), 0,
                    127).astype(np.float32)
    pvalid = rng.random(props.shape[:2]) < 0.9
    key = jax.random.key(9)
    keys = jax.random.split(key, 2)
    want = jax.vmap(lambda k, p, v, g, l, gv: JM.rcnn_stage(k, p, v, g, l, gv, NC, num=16))(
        keys, jnp.asarray(props), jnp.asarray(pvalid), *(jnp.asarray(tgt[k]) for k in
                                                         ("boxes", "labels", "valid")))
    got = M.rcnn_stage(_t(props), _t(pvalid), _t(tgt["boxes"]), _t(tgt["labels"]),
                       _t(tgt["valid"]), NC, _t(jax_draws(key, 2, props.shape[1] + 6)), num=16)
    for k in ("labels", "pos", "valid", "assigned_gt"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    for k in ("rois", "reg_targets"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-6)
    assert got["pos"].any() and (~got["pos"] & got["valid"]).any()
    # the box losses on those targets
    R = 32
    cls = rng.standard_normal((R, NC + 1)).astype(np.float32)
    reg = rng.standard_normal((R, NC, 4)).astype(np.float32)
    flat_w = jax.tree_util.tree_map(lambda a: a.reshape((-1,) + a.shape[2:]), want)
    flat_g = {k: v.reshape(-1, *v.shape[2:]) for k, v in got.items()}
    for g, w in zip(M.rcnn_loss(_t(cls), _t(reg), flat_g),
                    JM.rcnn_loss(jnp.asarray(cls), jnp.asarray(reg), flat_w)):
        assert abs(float(g) - float(w)) <= 1e-6 * abs(float(w))
    # the mask loss: every image's rois against its own gt masks
    logits = rng.standard_normal((2, 16, 8, 8, NC)).astype(np.float32)
    wm = jax.vmap(JM.mask_loss)(jnp.asarray(logits), want["rois"], want["assigned_gt"],
                                want["labels"], want["pos"], jnp.asarray(tgt["masks"])).mean()
    gm = M.mask_loss(_t(logits), got["rois"], got["assigned_gt"], got["labels"], got["pos"],
                     _t(tgt["masks"]))
    assert abs(float(gm) - float(wm)) <= 1e-6 * abs(float(wm))


def test_decode_matches_jax():
    rng = np.random.default_rng(10)
    R = 64
    cls = (rng.standard_normal((2, R, NC + 1)) * 2).astype(np.float32)
    reg = rng.standard_normal((2, R, NC, 4)).astype(np.float32)
    rois = np.clip(np.sort(rng.uniform(0, 128, (2, R, 2, 2)), axis=2).reshape(2, R, 4), 0,
                   127).astype(np.float32)
    got = M.mask_rcnn_decode(_t(cls), _t(reg), _t(rois), 128, score_thr=0.0)
    for i in range(2):
        want = JM.mask_rcnn_decode(jnp.asarray(cls[i]), jnp.asarray(reg[i]),
                                   jnp.asarray(rois[i]), 128, score_thr=0.0)
        for k in ("labels", "roi_index"):
            np.testing.assert_array_equal(got[i][k], want[k], err_msg=k)
        np.testing.assert_allclose(got[i]["boxes"], want["boxes"], rtol=0, atol=1e-4)
        np.testing.assert_allclose(got[i]["scores"], want["scores"], rtol=0, atol=1e-7)


def test_forward_matches_jax(narrow):
    """features + RPN in eval at canvas 128 (padded windows): 1e-5 of the
    largest."""
    m, x = narrow["m"], narrow["x"]
    want_f, want_c, want_r = jax.jit(narrow["jm"].apply)(narrow["v"], jnp.asarray(x))
    with torch.no_grad():
        feats, cls, reg = m(torch.from_numpy(x))
    assert [tuple(f.shape[1:3]) for f in feats] == [(32, 32), (16, 16), (8, 8), (4, 4), (2, 2)]
    for got, want in ((cls, want_c), (reg, want_r), *zip(feats, want_f)):
        want = np.asarray(want)
        np.testing.assert_allclose(_np(got), want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_train_step_matches_jax(narrow):
    """The two-stage train loss at canvas 128 with the samplers fed JAX's
    draws: each of the five losses within 1e-4, the positive count equal,
    the proposals JAX's, per-tensor grad norms within 1e-3."""
    m = narrow["m"]
    m.load_state_dict(narrow["sd"])
    m.train()
    tgt = {k: _t(v) for k, v in narrow["tgt"].items()}
    total, losses = M.mask_rcnn_losses(m, torch.from_numpy(narrow["x"]), tgt["boxes"],
                                       tgt["labels"], tgt["valid"], tgt["masks"],
                                       _t(narrow["anchors"]), narrow["levels"],
                                       _t(narrow["u_rpn"]), _t(narrow["u_rcnn"]), RPN_S, RCNN_S,
                                       PROPS)
    params = dict(m.named_parameters())
    grads = dict(zip(params, torch.autograd.grad(total, list(params.values()))))
    m.eval()
    assert int(losses["num_pos"]) == int(narrow["losses"]["num_pos"]) > 0
    for k in ("rpn_cls", "rpn_reg", "cls", "reg", "mask"):
        assert abs(float(losses[k]) - narrow["losses"][k]) <= 1e-4 * abs(narrow["losses"][k]), k
    state = {k: t.detach() for k, t in m.state_dict().items()}
    assert_grad_norms(narrow["grads"], grads, state, narrow["template"], bridge)


def test_bridge_reaches_every_leaf_and_inverts(narrow):
    assert_bridge_inverts(narrow["sd"], narrow["v"], bridge)
    assert {"rpn_head.rpn_conv.weight", "roi_head.bbox_head.shared_fcs.0.weight",
            "roi_head.bbox_head.fc_reg.bias", "roi_head.mask_head.convs.3.conv.weight",
            "roi_head.mask_head.upsample.weight", "roi_head.mask_head.conv_logits.bias",
            "neck.extra_trans_convs.1.weight"} <= set(narrow["sd"])


def test_golden_file_layout():
    g = np.load(GOLDEN)
    A = len(M.mask_rcnn_anchors(int(g["canvas"])))
    assert int(g["canvas"]) == 512 and A == 65472 and g["rpn_rows"].shape == (256,)
    assert g["proposals"].shape == (2, 256, 4) and g["roi_cls_rows"].shape == (2, 48, 81)
    assert g["det_roi_index"].shape == (2, 100) and g["det_mask_sums"].shape == (2, 100)
    assert g["u_rpn_pos_idx"].shape == (2, 128) and g["u_rpn_neg_idx"].shape == (2, 256)
    assert g["u_rcnn_pos_idx"].shape == (2, 32) and g["u_rcnn_neg_idx"].shape == (2, 128)
    m = create_model("mask_rcnn_efficientvit_m4", device="meta")
    assert sorted(n for n, _ in m.named_parameters()) == list(g["names"])


# ----------------------------------------------------------- golden writer

def level_sums(t: np.ndarray, level_sizes) -> np.ndarray:
    out, off = [], 0
    for n in level_sizes:
        out.append(t[:, off:off + n].astype(np.float64).sum(axis=1))
        off += n
    return np.stack(out, axis=1)


def write_golden(path: Path = GOLDEN, canvas: int = 512, batch: int = 2) -> None:
    """JAX's Mask R-CNN-M4 at `canvas` on the port's seeded weights, with
    the CLI's sampler sizes (256 RPN samples, 128 rois, 256 proposals): the
    outputs, proposals and decode in fp32, the train step in float64."""
    name = "mask_rcnn_efficientvit_m4"
    rpn_s, rcnn_s, props_n, max_boxes = 256, 128, 256, 32
    port = create_model(name, canvas=canvas, device="cpu")
    sd = seeded_state_dict(port, WEIGHT_SEED)
    jm = jax_create_model(name)
    x = images(INPUT_SEED, batch, canvas)
    template = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.asarray(x)))
    v = jax_detector_variables(sd, template, bridge)
    anchors = M.mask_rcnn_anchors(canvas)
    levels = M.mask_rcnn_anchor_levels(canvas)
    rows = np.sort(np.random.default_rng(ROWS_SEED).choice(len(anchors), 256, replace=False))

    @jax.jit
    def infer(v, x):
        feats = jm.apply(v, x, False, method=JM.MaskRCNN.features)
        rpn_cls, rpn_reg = jm.apply(v, feats, method=JM.MaskRCNN.rpn)
        props, pscore = JM.rpn_proposals(rpn_cls, rpn_reg, jnp.asarray(anchors), levels, canvas,
                                         max_per_img=props_n)
        cls, reg = jm.apply(v, feats, jax_rois_flat(props), method=JM.MaskRCNN.roi_bbox)
        return feats, rpn_cls, rpn_reg, props, pscore, cls, reg
    feats, rpn_cls, rpn_reg, props, pscore, cls, reg = infer(v, jnp.asarray(x))
    B, R = props.shape[:2]
    cls, reg = cls.reshape(B, R, -1), reg.reshape(B, R, -1, 4)
    dets = [JM.mask_rcnn_decode(cls[i], reg[i], props[i], canvas, score_thr=0.0)
            for i in range(B)]
    det_rois = np.concatenate([np.concatenate([np.full((100, 1), i, np.float32),
                                               d["boxes"][:100]], 1)
                               for i, d in enumerate(dets)])
    mlog = np.asarray(jax.jit(lambda v, f, r: jm.apply(v, f, r, method=JM.MaskRCNN.roi_mask))(
        v, feats, jnp.asarray(det_rois))).reshape(B, 100, 28, 28, -1)
    labels = np.stack([d["labels"][:100] for d in dets])
    mask_sums = np.take_along_axis(mlog.sum(axis=(2, 3)), labels[..., None], -1)[..., 0]
    roi_rows = np.sort(np.random.default_rng(ROWS_SEED + 1).choice(R, 48, replace=False))

    tgt = synthetic_targets(np.random.default_rng(TARGET_SEED), batch, canvas, max_boxes, 80)
    key = jax.random.key(KEY_SEED)
    # the train step in float64 (JAX's fp32 CPU grads sit up to ~1.5% off
    # float64 where train-mode BN's E[x^2] - E[x]^2 variance cancels), the
    # samplers' draws JAX's fp32 ones, as its fp32 CLI draws them
    jax.config.update("jax_enable_x64", True)
    uniform = jax.random.uniform
    jax.random.uniform = lambda k, shape=(), dtype=None, minval=0.0, maxval=1.0: uniform(
        k, shape, jnp.float32, minval, maxval)
    try:
        jm = jax_create_model(name, dtype=jnp.float64)
        v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), v)
        loss_fn = jax_step_loss(jm, x.astype(np.float64), tgt, anchors, levels, key, canvas, 80,
                                rpn_s, rcnn_s, props_n)
        (loss, (losses, tprops, tscore)), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(v["params"], v["batch_stats"])
        # the sampled order of JAX's draws, from JAX's own masks
        r_rpn, r_rcnn = jax.random.split(key)
        u_rpn = jax_draws(r_rpn, batch, len(anchors))
        u_rcnn = jax_draws(r_rcnn, batch, max_boxes + props_n)
    finally:
        jax.random.uniform = uniform
        jax.config.update("jax_enable_x64", False)
    rpn_a = np.stack([np.asarray(JM.max_iou_assign(jnp.asarray(anchors), tgt["boxes"][b],
                                                   tgt["valid"][b], 0.7, 0.3, 0.3))
                      for b in range(batch)])
    cand = np.concatenate([tgt["boxes"], np.asarray(tprops)], 1)
    cand_valid = np.concatenate([tgt["valid"], np.asarray(tscore) > 0], 1)
    rcnn_a = np.stack([np.asarray(JM.max_iou_assign(jnp.asarray(cand[b]), tgt["boxes"][b],
                                                    tgt["valid"][b], 0.5, 0.5, 0.5))
                       for b in range(batch)])
    draws = {}
    for tag, u, a, valid, cap, k in (
            ("rpn", u_rpn, rpn_a, np.ones_like(rpn_a, bool), rpn_s // 2, rpn_s),
            ("rcnn", u_rcnn, rcnn_a, cand_valid, rcnn_s // 4, rcnn_s)):
        for kind, mask, kk in (("pos", (a >= 0) & valid, cap), ("neg", (a == -1) & valid, k)):
            draws[f"u_{tag}_{kind}_idx"], draws[f"u_{tag}_{kind}"] = top_of_draws(
                u[:, 0 if kind == "pos" else 1], mask, kk)
    named = bridge({"params": grads, "batch_stats": v["batch_stats"]})
    names = sorted(n for n, _ in port.named_parameters())
    stack = lambda k: np.stack([d[k][:100] for d in dets])  # noqa: E731
    np.savez_compressed(
        path, weight_seed=WEIGHT_SEED, input_seed=INPUT_SEED, target_seed=TARGET_SEED,
        canvas=canvas, batch=batch, rpn_samples=rpn_s, rcnn_samples=rcnn_s, proposals_n=props_n,
        max_boxes=max_boxes, rpn_rows=rows,
        rpn_cls_rows=np.asarray(rpn_cls)[:, rows], rpn_reg_rows=np.asarray(rpn_reg)[:, rows],
        rpn_cls_level_sums=level_sums(np.asarray(rpn_cls)[..., None], levels)[..., 0],
        rpn_reg_level_sums=level_sums(np.asarray(rpn_reg), levels),
        proposals=np.asarray(props), proposal_scores=np.asarray(pscore), roi_rows=roi_rows,
        roi_cls_rows=np.asarray(cls)[:, roi_rows], roi_reg_rows=np.asarray(reg)[:, roi_rows],
        det_boxes=stack("boxes"), det_scores=stack("scores"), det_labels=stack("labels"),
        det_roi_index=stack("roi_index"), det_mask_sums=mask_sums.astype(np.float32),
        train_proposals=np.asarray(tprops), loss=float(loss),
        **{f"loss_{k}": float(t) for k, t in losses.items()}, **draws,
        names=np.asarray(names),
        grad_norms=np.asarray([np.linalg.norm(named[n].numpy()) for n in names], np.float32),
        grad_norm=float(np.sqrt(sum(np.sum(np.square(np.asarray(g), dtype=np.float64))
                                    for g in jax.tree_util.tree_leaves(grads)))))
    print(f"wrote {path} ({path.stat().st_size} bytes), loss {float(loss):.6f}, "
          f"losses {({k: float(t) for k, t in losses.items()})}")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    write_golden()
