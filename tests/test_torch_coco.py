"""cream_tpu_torch's COCO side (`data/coco.py`, `train/coco_eval.py`) and
the two detection CLIs (`cli/train_retinanet.py`, `cli/train_mask_rcnn.py`),
on the CPU.

The dataset, the RLE and polygon rasterization, the loader and the native
AP are held to the JAX package's on the same inputs (a tiny COCO folder the
test writes with PIL); the mask pasting's PIL-free bilinear resize to PIL
itself, bit for bit; the CLIs run end to end with `--cpu`, synthetic and
on the folder.
"""
import json

import numpy as np
import pytest
import torch

from cream_tpu.cli.train_mask_rcnn import paste_mask as jax_paste_mask
from cream_tpu.data import coco as JC
from cream_tpu.train import coco_eval as JE
from cream_tpu_torch.cli import train_mask_rcnn, train_retinanet
from cream_tpu_torch.data import coco as C
from cream_tpu_torch.train import coco_eval as E
from torch_threads import one_torch_thread_module  # noqa: F401


@pytest.fixture(scope="module")
def coco_dir(tmp_path_factory):
    """Five small RGB images with boxes, polygons and a crowd RLE."""
    from PIL import Image
    root = tmp_path_factory.mktemp("coco")
    rng = np.random.default_rng(0)
    images, anns = [], []
    aid = 1
    for i in range(5):
        w, h = int(rng.integers(60, 100)), int(rng.integers(50, 90))
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(root / f"{i}.png")
        images.append({"id": 10 + i, "file_name": f"{i}.png", "width": w, "height": h})
        for _ in range(int(rng.integers(1, 4))):
            x, y = float(rng.uniform(0, w * 0.5)), float(rng.uniform(0, h * 0.5))
            bw, bh = float(rng.uniform(8, w * 0.5)), float(rng.uniform(8, h * 0.5))
            poly = [x, y, x + bw, y, x + bw * 0.7, y + bh, x, y + bh * 0.8]
            anns.append({"id": aid, "image_id": 10 + i, "category_id": int(rng.integers(1, 4)),
                         "bbox": [x, y, bw, bh], "iscrowd": 0, "segmentation": [poly]})
            aid += 1
        if i == 2:                                          # a crowd region as RLE
            counts = [w * 5 + 3, 40, h * 3, 30, w * h - w * 5 - 3 - 40 - h * 3 - 30]
            anns.append({"id": aid, "image_id": 10 + i, "category_id": 1, "iscrowd": 1,
                         "bbox": [5, 3, 20, 20], "segmentation": {"counts": counts,
                                                                  "size": [h, w]}})
            aid += 1
    ann = {"images": images, "annotations": anns,
           "categories": [{"id": c, "name": str(c)} for c in (1, 2, 3)]}
    path = root / "instances.json"
    path.write_text(json.dumps(ann))
    return root, path


def test_dataset_and_loader_match_jax(coco_dir):
    root, ann = coco_dir
    port, ref = C.CocoDetection(str(root), str(ann)), JC.CocoDetection(str(root), str(ann))
    assert port.ids == ref.ids and port.categories == ref.categories
    for train in (False, True):
        kw = dict(canvas=(64, 64), size=48, max_size=64, max_boxes=4, train=train, seed=3,
                  with_masks=True, mask_stride=4)
        got = list(C.detection_loader(port, 2, **kw))
        want = list(JC.detection_loader(ref, 2, **kw))
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            assert g["masks"].any()


def test_rle_and_polygons_match_jax():
    counts = [7, 5, 11, 3, 14]
    np.testing.assert_array_equal(C.decode_rle(counts, (8, 5)), JC.decode_rle(counts, (8, 5)))
    poly = [[2.5, 1.0, 30.0, 4.0, 22.0, 25.5, 3.0, 18.0]]
    for flip in (None, 40.0):
        np.testing.assert_array_equal(C.rasterize_instance(poly, 9, 11, 0.3, 0.35, flip),
                                      JC.rasterize_instance(poly, 9, 11, 0.3, 0.35, flip))
    rle = {"counts": counts, "size": [8, 5]}
    np.testing.assert_array_equal(C.rasterize_instance(rle, 16, 10, 2.0, 2.0),
                                  JC.rasterize_instance(rle, 16, 10, 2.0, 2.0))


def _dets(rng, n_img: int = 6, segm: bool = False):
    gts, dts = {}, {}
    for i in range(n_img):
        g = int(rng.integers(1, 5))
        gb = np.concatenate([rng.uniform(0, 200, (g, 2)), rng.uniform(5, 150, (g, 2))], 1)
        d = int(rng.integers(0, 8))
        jitter = gb[rng.integers(0, g, d)] + rng.normal(0, 10, (d, 4))
        db = np.abs(jitter)
        gts[i] = {"boxes": gb, "labels": rng.integers(0, 3, g),
                  "iscrowd": (rng.random(g) < 0.15).astype(np.int32)}
        dts[i] = {"boxes": db, "labels": rng.integers(0, 3, d), "scores": rng.random(d)}
        if segm:
            gts[i]["masks"] = rng.random((g, 24, 24)) < 0.3
            dts[i]["masks"] = rng.random((d, 24, 24)) < 0.3
    return gts, dts


@pytest.mark.parametrize("mode", ["bbox", "segm"])
def test_coco_eval_matches_jax(mode):
    gts, dts = _dets(np.random.default_rng(1 if mode == "bbox" else 2), segm=mode == "segm")
    kw = dict(max_dets=5, mode=mode, mask_area_scale=16.0)
    got, want = E.evaluate_detections(gts, dts, **kw), JE.evaluate_detections(gts, dts, **kw)
    assert got.keys() == want.keys()
    np.testing.assert_array_equal(list(got.values()), list(want.values()))


def test_coco_eval_perfect_detections():
    gts, _ = _dets(np.random.default_rng(3))
    dts = {i: {"boxes": g["boxes"], "labels": g["labels"], "scores": np.ones(len(g["boxes"]))}
           for i, g in gts.items()}
    for g in gts.values():
        g["iscrowd"] = np.zeros(len(g["boxes"]), np.int32)
    assert E.evaluate_detections(gts, dts)["AP"] == 1.0


@pytest.mark.parametrize("size", [(5, 7), (28, 28), (60, 13), (13, 60), (100, 120), (1, 1)])
def test_pil_bilinear_resize_is_pil(size):
    from PIL import Image
    a = np.random.default_rng(sum(size)).random((28, 28)).astype(np.float32)
    want = np.asarray(Image.fromarray(a, mode="F").resize(size, Image.BILINEAR))
    np.testing.assert_array_equal(C.pil_bilinear_resize(a, size), want)


def test_paste_mask_matches_jax():
    rng = np.random.default_rng(4)
    for box in ([10.0, 12.0, 90.0, 60.0], [-8.0, 100.0, 30.0, 140.0], [3.0, 3.0, 5.0, 4.0]):
        m28 = rng.random((28, 28)).astype(np.float32)
        np.testing.assert_array_equal(
            train_mask_rcnn.paste_mask(m28, np.asarray(box), 32),
            jax_paste_mask(m28, np.asarray(box), 32))


def test_retinanet_cli_synthetic(tmp_path):
    out = tmp_path / "r.json"
    res = train_retinanet.main(["--cpu", "--synthetic", "--steps", "2", "--canvas", "64",
                                "--batch-size", "2", "--num-classes", "4", "--max-boxes", "4",
                                "--out", str(out)])
    assert len(res["history"]) == 2 and np.isfinite(res["history"][-1]["total"])
    assert set(res["metrics"]) == {"AP", "AP50", "AP75", "APs", "APm", "APl", "AR100"}
    assert json.loads(out.read_text())["history"][0]["num_pos"] > 0


def test_mask_rcnn_cli_synthetic(tmp_path):
    res = train_mask_rcnn.main(["--cpu", "--synthetic", "--steps", "2", "--canvas", "64",
                                "--batch-size", "2", "--num-classes", "4", "--max-boxes", "4",
                                "--rpn-samples", "32", "--rcnn-samples", "16",
                                "--proposals", "24", "--max-dets", "10",
                                "--out", str(tmp_path / "m.json")])
    h = res["history"]
    assert len(h) == 2 and all(np.isfinite(h[-1][k]) for k in
                               ("rpn_cls", "rpn_reg", "cls", "reg", "mask"))
    assert {"bbox_AP", "segm_AP"} <= set(res["metrics"])


def test_clis_on_a_coco_folder(coco_dir, tmp_path):
    root, ann = coco_dir
    common = ["--cpu", "--coco-img-dir", str(root), "--coco-ann", str(ann), "--canvas", "64",
              "--resize", "48", "--batch-size", "2", "--num-classes", "4", "--max-boxes", "4"]
    r = train_retinanet.main(common + ["--steps", "1", "--out", str(tmp_path / "r.json")])
    assert np.isfinite(r["history"][0]["total"]) and "AP" in r["metrics"]
    m = train_mask_rcnn.main(common + ["--eval-only", "--rpn-samples", "32", "--rcnn-samples",
                                       "16", "--proposals", "24", "--max-dets", "10",
                                       "--out", str(tmp_path / "m.json")])
    assert "segm_AP" in m["metrics"]


def test_detr_cli_on_a_coco_folder(coco_dir, tmp_path):
    """The DETR CLI in COCO mode: a padded static-canvas batch (its pixel
    mask reaches the model), one step, then native AP; and --eval-only."""
    from cream_tpu_torch.cli import train_detr
    root, ann = coco_dir
    common = ["--cpu", "--coco-img-dir", str(root), "--coco-ann", str(ann), "--canvas", "64",
              "--resize", "48", "--batch-size", "2", "--num-classes", "4", "--max-boxes", "4",
              "--num-queries", "6", "--hidden-dim", "16", "--enc-layers", "1",
              "--dec-layers", "1"]
    r = train_detr.main(common + ["--steps", "1", "--out", str(tmp_path / "d.json")])
    assert np.isfinite(r["history"][0]["total"]) and "AP" in r["metrics"]
    e = train_detr.main(common + ["--eval-only", "--out", str(tmp_path / "e.json")])
    assert "AP" in e
