"""Detection losses: box ops, the sigmoid focal loss, and DETR's set
criterion (Hungarian matching, CE + L1 + GIoU).

Counterpart of `cream_tpu/train/detection.py` (iRPE/DETR-with-iRPE
models/{matcher.py,detr.py} and util/box_ops.py; the focal loss of the
vendored mmdet kernel). Targets are padded dense tensors: boxes (B, M, 4)
cxcywh in [0, 1], labels (B, M), valid (B, M) bool. The (B, Q, M) cost
tensor is computed on the device; only scipy's linear_sum_assignment runs
on the host, image by image, as the reference's matcher does.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def box_cxcywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], -1)


def box_xyxy_to_cxcywh(b: torch.Tensor) -> torch.Tensor:
    x0, y0, x1, y1 = b.unbind(-1)
    return torch.stack([(x0 + x1) / 2, (y0 + y1) / 2, x1 - x0, y1 - y0], -1)


def box_area(b: torch.Tensor) -> torch.Tensor:
    return (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])


def box_iou(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Pairwise IoU of xyxy boxes (..., N, 4) x (..., M, 4) -> (iou, union),
    each (..., N, M)."""
    area_a, area_b = box_area(a), box_area(b)
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / union, union


def generalized_box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise GIoU: IoU - (hull - union) / hull."""
    iou, union = box_iou(a, b)
    lt = torch.minimum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.maximum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp_min(0.0)
    hull = wh[..., 0] * wh[..., 1]
    return iou - (hull - union) / hull


BIG = 1e8


def matching_cost(pred_logits, pred_boxes, tgt_boxes, tgt_labels, tgt_valid,
                  cost_class: float = 1.0, cost_bbox: float = 5.0,
                  cost_giou: float = 2.0) -> torch.Tensor:
    """(B, Q, M) assignment cost (matcher.py:60-77); invalid target columns
    get +BIG, so the assignment ignores them."""
    prob = F.softmax(pred_logits, -1)
    labels = tgt_labels.long()[:, None, :].expand(-1, prob.shape[1], -1)
    c_class = -torch.gather(prob, -1, labels)
    c_bbox = (pred_boxes[:, :, None, :] - tgt_boxes[:, None, :, :]).abs().sum(-1)
    c_giou = -generalized_box_iou(box_cxcywh_to_xyxy(pred_boxes), box_cxcywh_to_xyxy(tgt_boxes))
    C = cost_bbox * c_bbox + cost_class * c_class + cost_giou * c_giou
    return torch.where(tgt_valid[:, None, :], C, BIG)


def hungarian_assign(cost: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Host-side linear_sum_assignment per image over the valid target
    columns: (B, M) int32, the query matched to each target (0 where the
    target is invalid; guard with `valid`)."""
    from scipy.optimize import linear_sum_assignment
    B, Q, M = cost.shape
    assign = np.zeros((B, M), np.int32)
    for i in range(B):
        cols = np.where(valid[i])[0]
        if len(cols) == 0:
            continue
        r, c = linear_sum_assignment(cost[i][:, cols])
        assign[i, cols[c]] = r
    return assign


def detection_loss(outputs: dict, tgt_boxes, tgt_labels, tgt_valid, assign,
                   num_classes: int, eos_coef: float = 0.1, num_boxes=None) -> dict:
    """SetCriterion's losses for one output set (detr.py:108-163): weighted
    CE over all queries (no-object class num_classes at weight eos_coef), L1
    and GIoU over matched pairs, the cardinality error."""
    logits, boxes = outputs["pred_logits"], outputs["pred_boxes"]
    B, Q = logits.shape[:2]
    if num_boxes is None:
        num_boxes = tgt_valid.sum().float().clamp_min(1.0)
    assign = assign.long()
    # matched labels scattered into a (B, Q) class map; an invalid slot
    # points past the queries and is dropped
    target_classes = torch.full((B, Q + 1), num_classes, dtype=torch.long, device=logits.device)
    safe = torch.where(tgt_valid, assign, Q)
    target_classes.scatter_(1, safe, torch.where(tgt_valid, tgt_labels.long(), num_classes))
    target_classes = target_classes[:, :Q]
    empty_w = torch.ones(num_classes + 1, device=logits.device)
    empty_w[num_classes] = eos_coef
    logp = F.log_softmax(logits.float(), -1)
    nll = -torch.gather(logp, -1, target_classes[..., None])[..., 0]
    w = empty_w[target_classes]
    loss_ce = (nll * w).sum() / w.sum()

    src_boxes = torch.gather(boxes, 1, assign[..., None].expand(-1, -1, 4))
    l1 = (src_boxes - tgt_boxes).abs().sum(-1)
    loss_bbox = torch.where(tgt_valid, l1, 0.0).sum() / num_boxes
    giou = generalized_box_iou(box_cxcywh_to_xyxy(src_boxes), box_cxcywh_to_xyxy(tgt_boxes))
    diag = torch.diagonal(giou, dim1=-2, dim2=-1)
    loss_giou = torch.where(tgt_valid, 1.0 - diag, 0.0).sum() / num_boxes

    card_pred = (logits.argmax(-1) != num_classes).sum(-1)
    card_err = (card_pred.float() - tgt_valid.sum(-1).float()).abs().mean()
    return {"loss_ce": loss_ce, "loss_bbox": loss_bbox, "loss_giou": loss_giou,
            "cardinality_error": card_err}


def criterion(outputs: dict, tgt_boxes, tgt_labels, tgt_valid, num_classes: int,
              eos_coef: float = 0.1, weight_dict: dict | None = None,
              cost_class: float = 1.0, cost_bbox: float = 5.0,
              cost_giou: float = 2.0) -> dict:
    """The whole SetCriterion: the host matching and the losses of the final
    and auxiliary outputs, weighted as detr.py:380-389 (ce 1, bbox 5, giou
    2; aux losses suffixed _i); 'total' holds the weighted sum."""
    if weight_dict is None:
        weight_dict = {"loss_ce": 1.0, "loss_bbox": 5.0, "loss_giou": 2.0}
    valid_np = tgt_valid.cpu().numpy()

    def match(out):
        with torch.no_grad():
            C = matching_cost(out["pred_logits"], out["pred_boxes"], tgt_boxes, tgt_labels,
                              tgt_valid, cost_class, cost_bbox, cost_giou)
        return torch.from_numpy(hungarian_assign(C.float().cpu().numpy(), valid_np)) \
            .to(tgt_boxes.device)

    num_boxes = tgt_valid.sum().float().clamp_min(1.0)
    losses = detection_loss(outputs, tgt_boxes, tgt_labels, tgt_valid, match(outputs),
                            num_classes, eos_coef, num_boxes)
    total = sum(losses[k] * w for k, w in weight_dict.items() if k in losses)
    for i, aux in enumerate(outputs.get("aux_outputs", [])):
        aux_l = detection_loss(aux, tgt_boxes, tgt_labels, tgt_valid, match(aux),
                               num_classes, eos_coef, num_boxes)
        total = total + sum(aux_l[k] * w for k, w in weight_dict.items() if k in aux_l)
        losses.update({f"{k}_{i}": v for k, v in aux_l.items()})
    losses["total"] = total
    return losses


def post_process(outputs: dict, target_sizes: torch.Tensor) -> list[dict]:
    """Per-image xyxy detections in absolute pixels (detr.py:258-287);
    target_sizes (B, 2) as (h, w)."""
    logits, boxes = outputs["pred_logits"], outputs["pred_boxes"]
    prob = F.softmax(logits, -1)
    scores, labels = prob[..., :-1].max(-1)
    xy = box_cxcywh_to_xyxy(boxes)
    h, w = target_sizes[:, 0], target_sizes[:, 1]
    xy = xy * torch.stack([w, h, w, h], -1)[:, None, :]
    return [{"scores": scores[i], "labels": labels[i], "boxes": xy[i]}
            for i in range(logits.shape[0])]


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor, gamma: float = 2.0,
                       alpha: float = 0.25) -> torch.Tensor:
    """Per-element focal loss of the vendored mmdet kernel
    (sigmoid_focal_loss_cuda.cu:20-49): logits (N, C); targets (N,) class
    ids 1..C, 0 = background (every column negative), < 0 = ignored.
    Returns (N, C); log(p) and log(1 - p) in the kernel's overflow-safe
    forms; grads by autograd."""
    C = logits.shape[-1]
    t = targets[..., None]
    d = torch.arange(C, device=logits.device)
    pos = (t == d + 1).to(logits.dtype)
    neg = ((t >= 0) & (t != d + 1)).to(logits.dtype)
    p = torch.sigmoid(logits)
    nonneg = (logits >= 0).to(logits.dtype)
    term1 = (1.0 - p) ** gamma * torch.log(p.clamp_min(1e-38))
    term2 = p ** gamma * (-logits * nonneg - torch.log1p(torch.exp(logits - 2.0 * logits * nonneg)))
    return -pos * term1 * alpha - neg * term2 * (1.0 - alpha)
