"""Native COCO detection and instance-segmentation AP (the pycocotools
COCOeval protocol), numpy only.

The port's own copy of `cream_tpu/train/coco_eval.py`: the reference
delegates AP to pycocotools (iRPE/DETR-with-iRPE/datasets/coco_eval.py:22-120,
engine.py:68); this is a dependency-free implementation of the same
published protocol:

  - greedy per-image matching in score order at 10 IoU thresholds
    .50:.05:.95, crowd GTs as ignore regions with IoU = inter / det_area,
    area-range GT/det ignoring, maxDets truncation;
  - accumulation into 101-point interpolated precision; AP averaged over
    thresholds x recall points x categories-with-GT; AR = mean max recall.

Boxes are xywh in absolute pixels (COCO convention). Box area uses w*h and
IoU uses the continuous (no +1) convention, exactly like maskUtils.iou.
"""
from __future__ import annotations

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
RECALL_THRS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}


def iou_xywh(dets: np.ndarray, gts: np.ndarray,
             iscrowd: np.ndarray) -> np.ndarray:
    """(D, G) IoU; for crowd gt g: inter / det_area (maskUtils.iou)."""
    D, G = len(dets), len(gts)
    out = np.zeros((D, G), np.float64)
    if D == 0 or G == 0:
        return out
    dx1, dy1 = dets[:, 0], dets[:, 1]
    dx2, dy2 = dets[:, 0] + dets[:, 2], dets[:, 1] + dets[:, 3]
    gx1, gy1 = gts[:, 0], gts[:, 1]
    gx2, gy2 = gts[:, 0] + gts[:, 2], gts[:, 1] + gts[:, 3]
    da = dets[:, 2] * dets[:, 3]
    ga = gts[:, 2] * gts[:, 3]
    iw = np.minimum(dx2[:, None], gx2[None]) - np.maximum(dx1[:, None], gx1[None])
    ih = np.minimum(dy2[:, None], gy2[None]) - np.maximum(dy1[:, None], gy1[None])
    inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
    union = np.where(iscrowd[None, :], da[:, None],
                     da[:, None] + ga[None, :] - inter)
    np.divide(inter, union, out=out, where=union > 0)
    return out


def iou_masks(det_masks: np.ndarray, gt_masks: np.ndarray,
              iscrowd: np.ndarray) -> np.ndarray:
    """(D, G) binary-mask IoU; crowd gt g: inter / det_area (maskUtils.iou).

    Masks are (N, Hm, Wm) bool at a common resolution (any stride of the
    image — IoU is scale-invariant; area-range gating is handled by the
    caller via mask_area_scale)."""
    D, G = len(det_masks), len(gt_masks)
    out = np.zeros((D, G), np.float64)
    if D == 0 or G == 0:
        return out
    d = det_masks.reshape(D, -1).astype(np.float64)
    g = gt_masks.reshape(G, -1).astype(np.float64)
    inter = d @ g.T
    da = d.sum(1)
    ga = g.sum(1)
    union = np.where(iscrowd[None, :], da[:, None],
                     da[:, None] + ga[None, :] - inter)
    np.divide(inter, union, out=out, where=union > 0)
    return out


def _evaluate_img(dets, det_scores, gts, gt_crowd, area_rng, max_det,
                  det_masks=None, gt_masks=None, mask_area_scale=1.0):
    """Match one (image, category): returns (dt_matches (T, D), dt_ignore
    (T, D), gt_ignore (G,), det order used) following COCOeval.evaluateImg.
    With det_masks/gt_masks (segm mode) IoU and area gating use the masks."""
    T = len(IOU_THRS)
    if gt_masks is not None:
        gt_area = gt_masks.reshape(len(gts), -1).sum(1) * mask_area_scale \
            if len(gts) else np.zeros(0)
    else:
        gt_area = gts[:, 2] * gts[:, 3] if len(gts) else np.zeros(0)
    gt_ig = gt_crowd | (gt_area < area_rng[0]) | (gt_area > area_rng[1])
    # gts sorted: non-ignored first (stable), like gtind = argsort(_ignore)
    gind = np.argsort(gt_ig, kind="stable")
    gts = gts[gind]
    gt_crowd = gt_crowd[gind]
    gt_ig = gt_ig[gind]

    dind = np.argsort(-det_scores, kind="stable")[:max_det]
    dets = dets[dind]
    if det_masks is not None:
        ious = iou_masks(det_masks[dind], gt_masks[gind], gt_crowd)
    else:
        ious = iou_xywh(dets, gts, gt_crowd)

    D, G = len(dets), len(gts)
    dtm = np.zeros((T, D), np.int64) - 1
    gtm = np.zeros((T, G), np.int64) - 1
    dt_ig = np.zeros((T, D), bool)
    for ti, t in enumerate(IOU_THRS):
        for d in range(D):
            best = min(t, 1 - 1e-10)
            m = -1
            for g in range(G):
                if gtm[ti, g] >= 0 and not gt_crowd[g]:
                    continue                     # gt taken (crowds re-match)
                if m > -1 and not gt_ig[m] and gt_ig[g]:
                    break                        # past non-ignored into ignored
                if ious[d, g] < best:
                    continue
                best = ious[d, g]
                m = g
            if m == -1:
                continue
            dt_ig[ti, d] = gt_ig[m]
            dtm[ti, d] = m
            gtm[ti, m] = d
    # unmatched dets outside the area range are ignored
    if det_masks is not None:
        det_area = det_masks[dind].reshape(D, -1).sum(1) * mask_area_scale \
            if D else np.zeros(0)
    else:
        det_area = dets[:, 2] * dets[:, 3] if D else np.zeros(0)
    out_rng = (det_area < area_rng[0]) | (det_area > area_rng[1])
    dt_ig = dt_ig | ((dtm < 0) & out_rng[None, :])
    return dtm, dt_ig, gt_ig, det_scores[dind]


def evaluate_detections(groundtruths: dict, detections: dict,
                        max_dets: int = 100, mode: str = "bbox",
                        mask_area_scale: float = 1.0) -> dict:
    """COCO bbox (mode="bbox") or instance-segmentation (mode="segm") metrics.

    groundtruths: {image_id: {"boxes" (G,4) xywh, "labels" (G,),
                              "iscrowd" (G,) optional,
                              "masks" (G,Hm,Wm) bool — segm mode}}
    detections:   {image_id: {"boxes" (D,4) xywh, "labels" (D,),
                              "scores" (D,), "masks" (D,Hm,Wm) — segm mode}}
    In segm mode IoU and area gating use the binary masks (COCOeval iouType
    'segm'); masks may live at a reduced canvas stride, with pixel counts
    scaled back to image area via mask_area_scale (= stride**2).
    Returns the 6 headline numbers (AP, AP50, AP75, APs, APm, APl) + AR100.
    """
    segm = mode == "segm"
    cats = sorted({int(l) for g in groundtruths.values()
                   for l in np.asarray(g["labels"]).ravel()})
    T, R = len(IOU_THRS), len(RECALL_THRS)
    results = {}
    for rng_name, area_rng in AREA_RANGES.items():
        precision = np.full((T, R, len(cats)), -1.0)
        recall_out = np.full((T, len(cats)), -1.0)
        for ci, cat in enumerate(cats):
            all_scores, all_dtm, all_dtig = [], [], []
            n_gt = 0
            for img_id, gt in groundtruths.items():
                g_lab = np.asarray(gt["labels"]).ravel()
                g_sel = g_lab == cat
                g_boxes = np.asarray(gt["boxes"], np.float64).reshape(-1, 4)[g_sel]
                g_crowd = np.asarray(gt.get("iscrowd",
                                            np.zeros(len(g_lab)))).astype(bool)[g_sel]
                det = detections.get(img_id, {"boxes": np.zeros((0, 4)),
                                              "labels": np.zeros(0),
                                              "scores": np.zeros(0),
                                              "masks": np.zeros((0, 1, 1))})
                d_lab = np.asarray(det["labels"]).ravel()
                d_sel = d_lab == cat
                d_boxes = np.asarray(det["boxes"], np.float64).reshape(-1, 4)[d_sel]
                d_scores = np.asarray(det["scores"], np.float64).ravel()[d_sel]
                if len(g_boxes) == 0 and len(d_boxes) == 0:
                    continue
                if segm:
                    g_m = np.asarray(gt["masks"], bool)[g_sel]
                    d_m = np.asarray(det["masks"], bool)[d_sel]
                else:
                    g_m = d_m = None
                dtm, dt_ig, gt_ig, scores = _evaluate_img(
                    d_boxes, d_scores, g_boxes, g_crowd, area_rng, max_dets,
                    det_masks=d_m, gt_masks=g_m,
                    mask_area_scale=mask_area_scale)
                all_scores.append(scores)
                all_dtm.append(dtm)
                all_dtig.append(dt_ig)
                n_gt += int((~gt_ig).sum())
            if n_gt == 0:
                continue
            if all_scores:
                scores = np.concatenate(all_scores)
                dtm = np.concatenate(all_dtm, axis=1)
                dt_ig = np.concatenate(all_dtig, axis=1)
                order = np.argsort(-scores, kind="mergesort")
                dtm = dtm[:, order]
                dt_ig = dt_ig[:, order]
            else:
                dtm = np.zeros((T, 0), np.int64)
                dt_ig = np.zeros((T, 0), bool)
            tps = (dtm >= 0) & ~dt_ig
            fps = (dtm < 0) & ~dt_ig
            tp_cum = np.cumsum(tps, axis=1).astype(np.float64)
            fp_cum = np.cumsum(fps, axis=1).astype(np.float64)
            for ti in range(T):
                tp, fp = tp_cum[ti], fp_cum[ti]
                rc = tp / n_gt
                pr = tp / np.maximum(tp + fp, np.spacing(1))
                recall_out[ti, ci] = rc[-1] if len(rc) else 0.0
                # monotone-decreasing interpolation from the right
                pr = pr.tolist()
                for k in range(len(pr) - 1, 0, -1):
                    pr[k - 1] = max(pr[k - 1], pr[k])
                inds = np.searchsorted(rc, RECALL_THRS, side="left")
                q = np.zeros(R)
                for ri, pi in enumerate(inds):
                    if pi < len(pr):
                        q[ri] = pr[pi]
                precision[:, :, ci][ti] = q
        valid = precision > -1
        ap = precision[valid].mean() if valid.any() else float("nan")
        results[rng_name] = float(ap)
        if rng_name == "all":
            for t, key in ((0.5, "AP50"), (0.75, "AP75")):
                ti = int(np.argmin(np.abs(IOU_THRS - t)))
                p = precision[ti][precision[ti] > -1]
                results[key] = float(p.mean()) if p.size else float("nan")
            r = recall_out[recall_out > -1]
            results["AR100"] = float(r.mean()) if r.size else float("nan")
    return {"AP": results["all"], "AP50": results["AP50"],
            "AP75": results["AP75"], "APs": results["small"],
            "APm": results["medium"], "APl": results["large"],
            "AR100": results["AR100"]}
