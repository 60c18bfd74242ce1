"""cream_tpu_torch's detection ops (`ops/detection.py`: IoU, NMS, RoIAlign,
Soft-NMS, RoIPool, deformable and masked convolution) and DETR's set
losses (`train/detection.py`), against the JAX package's on numpy-seeded
inputs (fp32, on the CPU).

NMS is held index for index (indices and validity) at both box
conventions, at scores with exact ties, with fewer and more kept boxes than
outputs, and at the class-offset magnitude of the detectors' decodes
(labels x 1e5 added to the boxes, where fp32 resolves 0.5).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cream_tpu.ops import detection as JD
from cream_tpu.train import detection as JT
from cream_tpu_torch.ops import detection as D
from cream_tpu_torch.train import detection as T
from torch_threads import one_torch_thread_module  # noqa: F401


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t):
    return t.detach().float().numpy()


def random_boxes(rng, n: int, size: float = 100.0, clusters: int = 12) -> np.ndarray:
    """Boxes clustered around a few centres, so many overlap near any
    threshold."""
    c = rng.uniform(0, size, (clusters, 2))[rng.integers(0, clusters, n)]
    xy = c + rng.normal(0, size * 0.05, (n, 2))
    wh = rng.uniform(size * 0.05, size * 0.3, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


@pytest.mark.parametrize("legacy", [False, True])
@pytest.mark.parametrize("thr,max_out", [(0.5, 40), (0.3, 400), (0.7, 100)])
def test_nms_index_for_index(legacy, thr, max_out):
    rng = np.random.default_rng(int(thr * 10) + max_out + legacy)
    boxes = random_boxes(rng, 300)
    scores = np.round(rng.random(300) * 20) / 20          # exact ties: the lower index first
    scores[:10] = 0.0
    want_i, want_v = JD.nms(jnp.asarray(boxes), jnp.asarray(scores, jnp.float32), thr,
                            max_outputs=max_out, legacy_plus1=legacy)
    got_i, got_v = D.nms(_t(boxes), _t(scores.astype(np.float32)), thr, max_out, legacy)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    assert got_i.shape == (min(300, max_out),)


def test_nms_at_the_class_offset_magnitude():
    """The decodes' class-wise NMS: boxes + label * 1e5 (up to ~8e6, where
    fp32 resolves 0.5): the suppression decisions JAX's, index for index,
    with the boxes quantized so IoUs fall on the threshold."""
    rng = np.random.default_rng(3)
    n = 600
    boxes = np.round(random_boxes(rng, n, 512) * 2) / 2
    labels = rng.integers(0, 80, n)
    labels[: n // 2] = 79                                   # most at the top offset
    shifted = (boxes + labels[:, None].astype(np.float32) * 1e5).astype(np.float32)
    scores = rng.random(n).astype(np.float32)
    for thr in (0.5, 0.6):
        want_i, want_v = JD.nms(jnp.asarray(shifted), jnp.asarray(scores), thr, max_outputs=300)
        got_i, got_v = D.nms(_t(shifted), _t(scores), thr, 300)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_batched_nms_is_per_image_nms():
    rng = np.random.default_rng(4)
    boxes = np.stack([random_boxes(rng, 120) for _ in range(3)])
    scores = rng.random((3, 120)).astype(np.float32)
    idx, valid = D.batched_nms(_t(boxes), _t(scores), 0.5, 50)
    for b in range(3):
        i, v = D.nms(_t(boxes[b]), _t(scores[b]), 0.5, 50)
        assert torch.equal(idx[b], i) and torch.equal(valid[b], v)


def test_iou_matrix_bit_for_bit():
    rng = np.random.default_rng(5)
    a, b = random_boxes(rng, 50), random_boxes(rng, 70)
    for legacy in (False, True):
        np.testing.assert_array_equal(_np(D.iou_matrix(_t(a), _t(b), legacy)),
                                      np.asarray(JD.iou_matrix(jnp.asarray(a), jnp.asarray(b),
                                                               legacy)))


def _features_and_rois(seed: int, n: int = 30):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((2, 13, 17, 5)).astype(np.float32)
    xy = rng.uniform(-20, 60, (n, 2))
    rois = np.concatenate([rng.integers(0, 2, (n, 1)), xy, xy + rng.uniform(-2, 50, (n, 2))], 1)
    return feats, rois.astype(np.float32)        # some rois leave the map, some are inverted


@pytest.mark.parametrize("legacy,sample_num,scale", [(True, 2, 0.25), (False, 3, 0.5),
                                                     (True, 1, 1.0)])
def test_roi_align_and_grad_match_jax(legacy, sample_num, scale):
    feats, rois = _features_and_rois(6)
    want, vjp = jax.vjp(lambda f: JD.roi_align(f, jnp.asarray(rois), (4, 3), scale,
                                               sample_num=sample_num, legacy_plus1=legacy),
                        jnp.asarray(feats))
    f = _t(feats).requires_grad_()
    got = D.roi_align(f, _t(rois), (4, 3), scale, sample_num, legacy)
    w = np.random.default_rng(7).standard_normal(got.shape).astype(np.float32)
    (got * _t(w)).sum().backward()
    # the sample points' fp32 products in other roundings (XLA contracts a + b*c)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(f.grad), np.asarray(vjp(jnp.asarray(w))[0]), rtol=1e-5,
                               atol=1e-5)


def test_roi_align_bf16_features_give_fp32():
    """JAX's result type: fp32 weights times bf16 features."""
    feats, rois = _features_and_rois(8)
    got = D.roi_align(_t(feats).to(torch.bfloat16), _t(rois), (2, 2), 0.5)
    want = JD.roi_align(jnp.asarray(feats, jnp.bfloat16), jnp.asarray(rois), (2, 2), 0.5)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("method", ["linear", "gaussian", "hard"])
def test_soft_nms_matches_jax(method):
    rng = np.random.default_rng(9)
    boxes = random_boxes(rng, 60)
    scores = rng.random(60).astype(np.float32)
    want = JD.soft_nms(jnp.asarray(boxes), jnp.asarray(scores), 0.3, method, max_out=40)
    got = D.soft_nms(_t(boxes), _t(scores), 0.3, method, max_out=40)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-5, atol=1e-7)
    assert got[2] == int(want[2])


def test_roi_pool_matches_jax():
    feats, rois = _features_and_rois(10)
    want = JD.roi_pool(jnp.asarray(feats), jnp.asarray(rois), (3, 4), 0.5)
    got = D.roi_pool(_t(feats), _t(rois), (3, 4), 0.5)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("dg,stride,dil,modulated", [(1, 1, 1, False), (2, 2, 1, True),
                                                     (1, 1, 2, True)])
def test_deform_conv2d_and_grads_match_jax(dg, stride, dil, modulated):
    rng = np.random.default_rng(dg + stride + dil)
    x = rng.standard_normal((2, 9, 8, 4)).astype(np.float32)
    w = rng.standard_normal((3, 3, 4, 6)).astype(np.float32) * 0.3
    Ho = (9 + 2 - (dil * 2 + 1)) // stride + 1
    Wo = (8 + 2 - (dil * 2 + 1)) // stride + 1
    off = rng.normal(0, 1.5, (2, Ho, Wo, dg * 18)).astype(np.float32)
    mask = rng.random((2, Ho, Wo, dg * 9)).astype(np.float32) if modulated else None
    kw = dict(stride=stride, padding=1, dilation=dil, deformable_groups=dg)
    want, vjp = jax.vjp(lambda a, o: JD.deform_conv2d(a, o, jnp.asarray(w),
                                                      None if mask is None else jnp.asarray(mask),
                                                      **kw), jnp.asarray(x), jnp.asarray(off))
    xt, ot = _t(x).requires_grad_(), _t(off).requires_grad_()
    got = D.deform_conv2d(xt, ot, _t(w), None if mask is None else _t(mask), **kw)
    g = rng.standard_normal(got.shape).astype(np.float32)
    (got * _t(g)).sum().backward()
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=1e-5)
    jx, jo = vjp(jnp.asarray(g))
    np.testing.assert_allclose(_np(xt.grad), np.asarray(jx), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(ot.grad), np.asarray(jo), rtol=1e-4, atol=1e-4)


def test_masked_conv2d_matches_jax():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 7, 6, 3)).astype(np.float32)
    w = rng.standard_normal((3, 3, 3, 5)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    mask = (rng.random((2, 7, 6)) < 0.4).astype(np.float32)
    want = JD.masked_conv2d(jnp.asarray(x), jnp.asarray(mask), jnp.asarray(w), jnp.asarray(b))
    got = D.masked_conv2d(_t(x), _t(mask), _t(w), _t(b))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert (got.numpy()[mask == 0] == 0).all()


# ---------------------------------------------------------- DETR's losses

def _detr_outputs(seed: int, B: int = 2, Q: int = 10, C: int = 6):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, Q, C + 1)).astype(np.float32)
    boxes = rng.uniform(0.2, 0.6, (B, Q, 4)).astype(np.float32)
    tb = rng.uniform(0.2, 0.6, (B, 5, 4)).astype(np.float32)
    tl = rng.integers(0, C, (B, 5)).astype(np.int32)
    tv = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], bool)
    return logits, boxes, tb, tl, tv


def test_box_ops_match_jax():
    rng = np.random.default_rng(12)
    a = rng.uniform(0.1, 0.5, (7, 4)).astype(np.float32)
    b = rng.uniform(0.1, 0.5, (9, 4)).astype(np.float32)
    xa, xb = JT.box_cxcywh_to_xyxy(a), JT.box_cxcywh_to_xyxy(b)
    np.testing.assert_allclose(_np(T.box_cxcywh_to_xyxy(_t(a))), np.asarray(xa), rtol=1e-6)
    np.testing.assert_allclose(_np(T.box_xyxy_to_cxcywh(T.box_cxcywh_to_xyxy(_t(a)))), a,
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(T.generalized_box_iou(_t(np.asarray(xa)), _t(np.asarray(xb)))),
                               np.asarray(JT.generalized_box_iou(xa, xb)), rtol=1e-5, atol=1e-6)


def test_matching_and_criterion_match_jax():
    logits, boxes, tb, tl, tv = _detr_outputs(13)
    aux = _detr_outputs(14)
    outs = {"pred_logits": logits, "pred_boxes": boxes,
            "aux_outputs": [{"pred_logits": aux[0], "pred_boxes": aux[1]}]}
    want_c = JT.matching_cost(jnp.asarray(logits), jnp.asarray(boxes), jnp.asarray(tb),
                              jnp.asarray(tl), jnp.asarray(tv))
    got_c = T.matching_cost(_t(logits), _t(boxes), _t(tb), _t(tl), _t(tv))
    np.testing.assert_allclose(_np(got_c), np.asarray(want_c), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(T.hungarian_assign(_np(got_c), tv),
                                  JT.hungarian_assign(np.asarray(want_c), tv))
    jouts = jax.tree_util.tree_map(jnp.asarray, outs)
    want = JT.criterion(jouts, jnp.asarray(tb), jnp.asarray(tl), jnp.asarray(tv), 6)
    tout = {"pred_logits": _t(logits), "pred_boxes": _t(boxes),
            "aux_outputs": [{"pred_logits": _t(aux[0]), "pred_boxes": _t(aux[1])}]}
    got = T.criterion(tout, _t(tb), _t(tl), _t(tv), 6)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, atol=1e-6, err_msg=k)


def test_post_process_matches_jax():
    logits, boxes, *_ = _detr_outputs(15)
    sizes = np.array([[480, 640], [512, 512]], np.float32)
    want = JT.post_process({"pred_logits": jnp.asarray(logits), "pred_boxes": jnp.asarray(boxes)},
                           jnp.asarray(sizes))
    got = T.post_process({"pred_logits": _t(logits), "pred_boxes": _t(boxes)}, _t(sizes))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["labels"].numpy(), np.asarray(w["labels"]))
        np.testing.assert_allclose(_np(g["scores"]), np.asarray(w["scores"]), rtol=1e-6)
        np.testing.assert_allclose(_np(g["boxes"]), np.asarray(w["boxes"]), rtol=1e-5, atol=1e-4)
