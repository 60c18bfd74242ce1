"""Semantic-segmentation training pieces: OHEM cross-entropy, the deep-
supervision loss of CyDAS, and the confusion-matrix mIoU.

Counterpart of `cream_tpu/train/segmentation.py`
(CDARTS/CDARTS_segmentation/tools/seg_opr/loss_opr.py ProbOhemCrossEntropy2d
and train/seg_metrics.py, tools/utils/pyt_utils.py compute_hist): the
reference's boolean-mask indexing as sort + threshold + masked mean, the
same kept pixel set. The confusion histogram counts in int64 (the JAX
package's in fp32, exact below 2**24 pixels a cell).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def ohem_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, thresh: float = 0.7,
                       min_kept: int = 1, ignore: int = 255) -> torch.Tensor:
    """OHEM CE over NHWC logits and NHW int labels (loss_opr.py:66-96):
    with p_i the fp32 softmax probability of pixel i's target, the kept set
    is the valid pixels with p_i <= max(thresh, the min_kept-th smallest p)
    (an ignored pixel takes p = 1, so it sorts last and is never kept); the
    mean CE over the kept set. With fewer valid pixels than min_kept the
    threshold saturates at 1 and every valid pixel is kept."""
    valid = labels != ignore
    tgt = torch.where(valid, labels, 0).long()
    logp = F.log_softmax(logits.float(), dim=-1)
    ce = -torch.gather(logp, -1, tgt[..., None])[..., 0]
    with torch.no_grad():
        prob = torch.where(valid, torch.exp(-ce), 1.0)
        flat = torch.sort(prob.reshape(-1)).values
        k = min(max(int(min_kept), 1), flat.numel())
        threshold = flat[k - 1].clamp_min(thresh)
        kept = valid & (prob <= threshold)
        n = kept.sum().clamp_min(1)
    return torch.where(kept, ce, 0.0).sum() / n


def cydas_seg_loss(preds, labels: torch.Tensor, min_kept: int, thresh: float = 0.7,
                   ignore: int = 255, aux_weight: float = 0.2):
    """Deep supervision (train_cydas.py:415-423): OHEM on the main 1/8-path
    prediction plus `aux_weight` times OHEM on each auxiliary head's."""
    pred8, pred16, pred32 = preds
    loss8 = ohem_cross_entropy(pred8, labels, thresh, min_kept, ignore)
    loss16 = ohem_cross_entropy(pred16, labels, thresh, min_kept, ignore)
    loss32 = ohem_cross_entropy(pred32, labels, thresh, min_kept, ignore)
    return loss8 + aux_weight * (loss16 + loss32), {
        "loss8": loss8, "loss16": loss16, "loss32": loss32}


def seg_confusion(pred: torch.Tensor, labels: torch.Tensor, num_classes: int,
                  ignore: int = 255) -> torch.Tensor:
    """(C, C) int64 confusion histogram hist[target, pred] over the valid
    pixels (pyt_utils.compute_hist); sums across batches."""
    valid = (labels != ignore).reshape(-1)
    idx = labels.reshape(-1).long() * num_classes + pred.reshape(-1).long()
    return torch.bincount(idx[valid], minlength=num_classes * num_classes).reshape(
        num_classes, num_classes)


def miou_from_hist(hist: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(mIoU, per-class IoU) in float64; the mean over the classes present
    (row or column non-empty), as train_cydas.py:508-509."""
    hist = hist.double()
    inter = torch.diagonal(hist)
    union = hist.sum(0) + hist.sum(1) - inter
    iou = inter / union.clamp_min(1e-12)
    present = union > 0
    return (iou * present).sum() / present.sum().clamp_min(1), iou


def batch_intersection_union(pred: torch.Tensor, labels: torch.Tensor, num_classes: int,
                             ignore: int = 255) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-class (intersection, union) int64 counts (seg_metrics.py
    batch_intersection_union), the train loop's running-mIoU metric."""
    hist = seg_confusion(pred, labels, num_classes, ignore)
    inter = torch.diagonal(hist)
    return inter, hist.sum(0) + hist.sum(1) - inter
