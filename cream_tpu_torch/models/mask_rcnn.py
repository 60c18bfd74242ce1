"""Mask R-CNN over the EfficientViT-FPN backbone: the RPN, the RoI heads,
the samplers and targets, the five losses and the decode.

Counterpart of `cream_tpu/models/mask_rcnn.py` (the reference's
EfficientViT/downstream/configs/mask_rcnn_efficientvit_m4_fpn_1x_coco.py):
  - neck: EfficientViTFPN with two transposed-conv extra levels -> strides
    {4, 8, 16, 32, 64}
  - rpn_head: one 3x3 conv + ReLU, 1x1 objectness (sigmoid, 3 anchors a
    position: scale 8, ratios {.5, 1, 2}) and 1x1 deltas; assigner .7 / .3
    / .3, RandomSampler(256, .5); proposals: per-level top-k on the logits,
    decode, clip, one NMS at .7
  - roi_head: RoIAlign 7x7 (bbox) and 14x14 (mask) over strides {4, 8, 16,
    32}, each roi on its level floor(log2(sqrt(area) / 56)); the
    Shared2FCBBoxHead (2 fc 1024, softmax over 80 + background last,
    class-specific deltas with stds {.1, .1, .2, .2}); the FCNMaskHead (4
    3x3 convs, a 2x2 stride-2 transposed conv, 1x1 per-class logits, 28x28);
    rcnn assigner .5 / .5 / .5, RandomSampler(num, .25) with the gts added
    as proposals.

The samplers take their uniforms as arguments (JAX draws them inside from
its key): the caller draws them from its generator, and a test can feed
JAX's draws. RandomSampler is the JAX package's randomized-priority top-k,
ties to the lower index. The proposals' NMS syncs with the host once a
batch (`ops.detection.batched_nms`). GT masks ride at stride 4 and are
cropped to each positive roi with the same RoIAlign, as in JAX.

Parameter names are mmdet's: `rpn_head.rpn_conv`, `rpn_head.rpn_cls`,
`rpn_head.rpn_reg`, `roi_head.bbox_head.shared_fcs.{0,1}`, `.fc_cls`,
`.fc_reg`, `roi_head.mask_head.convs.{i}.conv`, `.upsample`,
`.conv_logits`; the first shared fc reads the RoI features flattened in
NCHW order, as mmdet's does (the JAX package flattens NHWC; `zoo.load`
permutes the kernel's rows).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from cream_tpu_torch.models.registry import register_model
from cream_tpu_torch.models.retinanet import (ConvModule, EfficientViTFPN, bbox2delta,
                                              conv_nhwc, conv_transpose_nhwc, delta2bbox,
                                              efficientvit_backbone, gather_detections,
                                              gen_base_anchors, grid_anchors, max_iou_assign,
                                              topk_stable)
from cream_tpu_torch.ops.detection import batched_nms, roi_align, roi_align_levels

MRCNN_STRIDES = (4, 8, 16, 32, 64)
ROI_STRIDES = (4, 8, 16, 32)
BBOX_STDS = (0.1, 0.1, 0.2, 0.2)
MASK_STRIDE = 4
RPN_ANCHORS = 3                 # scale 8 x 3 ratios a position


def mask_rcnn_anchors(canvas: int, strides=MRCNN_STRIDES) -> np.ndarray:
    """RPN anchors: scale 8, ratios {.5, 1, 2}, base size = stride."""
    out = []
    for s in strides:
        f = -(-canvas // s)
        out.append(grid_anchors(gen_base_anchors(s, [8.0], (0.5, 1.0, 2.0)), f, f, s))
    return np.concatenate(out, axis=0).astype(np.float32)


def mask_rcnn_anchor_levels(canvas: int, strides=MRCNN_STRIDES) -> list[int]:
    return [(-(-canvas // s)) ** 2 * 3 for s in strides]


class RPNHead(nn.Module):
    """mmdet RPNHead on every level: (objectness logits (B, A), deltas (B,
    A, 4))."""

    def __init__(self, in_channels: int = 256, feat_channels: int = 256, *,
                 dtype: torch.dtype, device):
        super().__init__()
        self.dtype = dtype
        self.rpn_conv = nn.Conv2d(in_channels, feat_channels, 3, padding=1, device=device)
        self.rpn_cls = nn.Conv2d(feat_channels, RPN_ANCHORS, 1, device=device)
        self.rpn_reg = nn.Conv2d(feat_channels, RPN_ANCHORS * 4, 1, device=device)

    def forward(self, feats: Sequence[torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
        co, ro = [], []
        for f in feats:
            h = torch.relu(conv_nhwc(self.rpn_conv, f, self.dtype))
            B = f.shape[0]
            co.append(conv_nhwc(self.rpn_cls, h, self.dtype).reshape(B, -1))
            ro.append(conv_nhwc(self.rpn_reg, h, self.dtype).reshape(B, -1, 4))
        return torch.cat(co, dim=1), torch.cat(ro, dim=1)


class BBoxHead(nn.Module):
    """Shared2FCBBoxHead: (R, 7, 7, C) NHWC RoI features flattened in NCHW
    order -> fc -> fc -> (class logits (R, C + 1), background last;
    class-specific deltas (R, C, 4))."""

    def __init__(self, num_classes: int = 80, in_channels: int = 256, roi_size: int = 7,
                 fc_channels: int = 1024, *, dtype: torch.dtype, device):
        super().__init__()
        self.dtype, self.num_classes = dtype, num_classes
        self.shared_fcs = nn.ModuleList([
            nn.Linear(in_channels * roi_size * roi_size, fc_channels, device=device),
            nn.Linear(fc_channels, fc_channels, device=device)])
        self.fc_cls = nn.Linear(fc_channels, num_classes + 1, device=device)
        self.fc_reg = nn.Linear(fc_channels, num_classes * 4, device=device)

    def _fc(self, fc: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, fc.weight.to(self.dtype), fc.bias.to(self.dtype))

    def forward(self, roi_feats: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        x = roi_feats.to(self.dtype).permute(0, 3, 1, 2).reshape(roi_feats.shape[0], -1)
        for fc in self.shared_fcs:
            x = torch.relu(self._fc(fc, x))
        return self._fc(self.fc_cls, x), self._fc(self.fc_reg, x).reshape(-1, self.num_classes, 4)


class MaskHead(nn.Module):
    """FCNMaskHead: 4 x (3x3 conv + ReLU), 2x2 stride-2 transposed conv +
    ReLU, 1x1 per-class logits: (R, 14, 14, C) -> (R, 28, 28, classes)."""

    def __init__(self, num_classes: int = 80, in_channels: int = 256, conv_channels: int = 256,
                 *, dtype: torch.dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.dtype = dtype
        self.convs = nn.ModuleList(ConvModule(in_channels if i == 0 else conv_channels,
                                              conv_channels, 3, 1, True, **kw) for i in range(4))
        self.upsample = nn.ConvTranspose2d(conv_channels, conv_channels, 2, 2, device=device)
        self.conv_logits = nn.Conv2d(conv_channels, num_classes, 1, device=device)

    def forward(self, roi_feats: torch.Tensor) -> torch.Tensor:
        x = roi_feats
        for conv in self.convs:
            x = conv(x)
        x = torch.relu(conv_transpose_nhwc(self.upsample, x, self.dtype))
        return conv_nhwc(self.conv_logits, x, self.dtype)


class RoIHead(nn.Module):
    """mmdet's StandardRoIHead: the box and mask heads."""

    def __init__(self, num_classes: int, channels: int, fc_channels: int = 1024,
                 mask_channels: int = 256, *, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.bbox_head = BBoxHead(num_classes, channels, fc_channels=fc_channels, **kw)
        self.mask_head = MaskHead(num_classes, channels, mask_channels, **kw)


class MaskRCNN(nn.Module):
    """The two stages as methods (`features`, `rpn`, `roi_bbox`,
    `roi_mask`) that the train step and the decode compose; `forward` is
    features + RPN. Rois are (R, 5) [batch index, x1, y1, x2, y2]. Train
    mode is the JAX package's `train=True`."""

    def __init__(self, backbone: nn.Module, in_channels: Sequence[int], canvas: int,
                 num_classes: int = 80, fpn_channels: int = 256, fc_channels: int = 1024,
                 mask_channels: int = 256, *, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.num_classes, self.dtype = num_classes, dtype
        self.img_size = self.canvas = canvas
        self.backbone = backbone
        self.neck = EfficientViTFPN(in_channels, fpn_channels, 2, **kw)
        self.rpn_head = RPNHead(fpn_channels, fpn_channels, **kw)
        self.roi_head = RoIHead(num_classes, fpn_channels, fc_channels, mask_channels, **kw)
        self.SEEDED_BRANCH_SCALE = getattr(backbone, "SEEDED_BRANCH_SCALE", 1.0)
        self.SEEDED_BRANCH_ENDS = getattr(backbone, "SEEDED_BRANCH_ENDS", ())

    def features(self, images: torch.Tensor) -> tuple[torch.Tensor, ...]:
        return self.neck(self.backbone.forward_pyramid(images))

    def rpn(self, feats):
        return self.rpn_head(feats)

    def roi_bbox(self, feats, rois: torch.Tensor):
        return self.roi_head.bbox_head(multilevel_roi_align(feats, rois, 7))

    def roi_mask(self, feats, rois: torch.Tensor) -> torch.Tensor:
        return self.roi_head.mask_head(multilevel_roi_align(feats, rois, 14))

    def forward(self, images: torch.Tensor, generator: torch.Generator | None = None):
        feats = self.features(images)
        return (feats, *self.rpn(feats))


def multilevel_roi_align(feats: Sequence[torch.Tensor], rois: torch.Tensor,
                         out_size: int) -> torch.Tensor:
    """SingleRoIExtractor over the first four levels (strides 4-32), each roi
    aligned on its own level only (fp32)."""
    return roi_align_levels(feats[:len(ROI_STRIDES)], rois, (out_size, out_size), ROI_STRIDES,
                            sample_num=2)


def rois_flat(rois_b: torch.Tensor) -> torch.Tensor:
    """(B, R, 4) xyxy -> (B*R, 5) with the batch index first."""
    B, R, _ = rois_b.shape
    bi = torch.arange(B, device=rois_b.device, dtype=torch.float32).repeat_interleave(R)
    return torch.cat([bi[:, None], rois_b.reshape(B * R, 4).float()], dim=1)


# ------------------------------------------------------------------ training

def random_sample(pos_mask: torch.Tensor, neg_mask: torch.Tensor, num: int,
                  pos_fraction: float, u_pos: torch.Tensor, u_neg: torch.Tensor):
    """mmdet's RandomSampler as the JAX package's randomized-priority top-k,
    over the last dim (leading dims batch): up to num * pos_fraction
    positives, the rest negatives; priorities u_pos / u_neg in [0, 1)
    (JAX's `uniform(r1)` / `uniform(r2)`). Returns (idx (..., num), is_pos,
    valid), the kept entries first."""
    n = pos_mask.shape[-1]
    num_pos_cap = min(int(num * pos_fraction), n)
    neg_k = min(num, n)
    pos_pri = torch.where(pos_mask, u_pos, -1.0)
    pos_idx = topk_stable(pos_pri, num_pos_cap)
    pos_ok = torch.gather(pos_pri, -1, pos_idx) > 0
    n_pos = pos_ok.sum(-1, keepdim=True)
    neg_pri = torch.where(neg_mask, u_neg, -1.0)
    neg_idx = topk_stable(neg_pri, neg_k)
    neg_ok = torch.gather(neg_pri, -1, neg_idx) > 0
    take_neg = torch.arange(neg_k, device=pos_mask.device) < (num - n_pos)
    idx = torch.cat([pos_idx, neg_idx], -1)
    keep = torch.cat([pos_ok, neg_ok & take_neg], -1)
    is_pos = torch.cat([pos_ok, torch.zeros_like(neg_ok)], -1)
    if idx.shape[-1] < num:                                   # n < num: pad slots
        pad = idx.new_zeros(*idx.shape[:-1], num - idx.shape[-1])
        idx = torch.cat([idx, pad], -1)
        keep = torch.cat([keep, pad.bool()], -1)
        is_pos = torch.cat([is_pos, pad.bool()], -1)
    order = torch.sort((~keep).to(torch.uint8), dim=-1, stable=True).indices
    idx = torch.gather(idx, -1, order)[..., :num]
    keep = torch.gather(keep, -1, order)[..., :num]
    is_pos = torch.gather(is_pos, -1, order)[..., :num]
    return idx, is_pos & keep, keep


def sigmoid_bce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """optax.sigmoid_binary_cross_entropy's form."""
    return logits.clamp_min(0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, n, ...) rows at idx (B, k) -> (B, k, ...)."""
    return torch.gather(x, 1, idx.view(*idx.shape, *([1] * (x.ndim - 2)))
                        .expand(*idx.shape, *x.shape[2:]))


def rpn_loss(rpn_cls: torch.Tensor, rpn_reg: torch.Tensor, anchors: torch.Tensor,
             gt_xyxy: torch.Tensor, gt_valid: torch.Tensor, uniforms: torch.Tensor,
             num_samples: int = 256) -> tuple[torch.Tensor, torch.Tensor]:
    """BCE objectness + L1 deltas on each image's sampled anchors (assigner
    .7 / .3 / .3, RandomSampler(num_samples, .5)), both over the sampled
    count, batch-averaged. uniforms (B, 2, A): each image's pos / neg
    priorities."""
    cls, reg = rpn_cls.float(), rpn_reg.float()
    assigned = max_iou_assign(anchors, gt_xyxy, gt_valid, 0.7, 0.3, 0.3)
    idx, is_pos, keep = random_sample(assigned >= 0, assigned == -1, num_samples, 0.5,
                                      uniforms[:, 0], uniforms[:, 1])
    n = keep.sum(1).clamp_min(1)
    bce = sigmoid_bce(torch.gather(cls, 1, idx), is_pos.float())
    cls_loss = torch.where(keep, bce, 0.0).sum(1) / n
    safe = torch.gather(assigned, 1, idx).clamp_min(0)
    deltas_t = bbox2delta(anchors[idx], _gather_rows(gt_xyxy, safe))
    l1 = (_gather_rows(reg, idx) - deltas_t).abs().sum(-1)
    reg_loss = torch.where(is_pos, l1, 0.0).sum(1) / n
    return cls_loss.mean(), reg_loss.mean()


@torch.no_grad()
def rpn_proposals(rpn_cls: torch.Tensor, rpn_reg: torch.Tensor, anchors: torch.Tensor,
                  level_sizes: Sequence[int], canvas: int, nms_pre: int = 500,
                  max_per_img: int = 256, iou_thr: float = 0.7
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """train_cfg.rpn_proposal: per level the top nms_pre logits, decoded and
    clipped to the canvas, then one NMS over the levels. Returns (proposals
    (B, max_per_img, 4), their sigmoid scores), 0 where NMS left no box.
    Carries no gradient (the JAX step's stop_gradient)."""
    cls, reg = rpn_cls.float(), rpn_reg.float()
    boxes_l, scores_l = [], []
    off = 0
    for n in level_sizes:
        s = cls[:, off:off + n]
        idx = topk_stable(s, min(nms_pre, n))
        boxes_l.append(delta2bbox(anchors[off:off + n][idx],
                                  _gather_rows(reg[:, off:off + n], idx),
                                  max_shape=(canvas, canvas)))
        scores_l.append(torch.gather(s, 1, idx))
        off += n
    boxes = torch.cat(boxes_l, 1)
    scores = torch.sigmoid(torch.cat(scores_l, 1))
    keep, valid = batched_nms(boxes, scores, iou_thr, max_per_img)
    props = torch.where(valid[..., None], _gather_rows(boxes, keep), 0.0)
    return props, torch.where(valid, torch.gather(scores, 1, keep), 0.0)


def rcnn_stage(proposals: torch.Tensor, prop_valid: torch.Tensor, gt_xyxy: torch.Tensor,
               gt_labels: torch.Tensor, gt_valid: torch.Tensor, num_classes: int,
               uniforms: torch.Tensor, num: int = 128, pos_fraction: float = 0.25) -> dict:
    """RCNN sampling and targets for a batch (train_cfg.rcnn: assigner .5 /
    .5 / .5, RandomSampler(num, pos_fraction) with the gts first among the
    candidates). uniforms (B, 2, G + P). Returns, each (B, num, ...): rois,
    labels (background = num_classes, -1 on padding), std-normalized
    reg_targets, pos, valid, assigned_gt."""
    boxes = torch.cat([gt_xyxy, proposals], dim=1)
    valid = torch.cat([gt_valid, prop_valid], dim=1)
    assigned = max_iou_assign(boxes, gt_xyxy, gt_valid, 0.5, 0.5, 0.5)
    idx, is_pos, keep = random_sample((assigned >= 0) & valid, (assigned == -1) & valid, num,
                                      pos_fraction, uniforms[:, 0], uniforms[:, 1])
    rois = _gather_rows(boxes, idx)
    agt = torch.gather(assigned, 1, idx).clamp_min(0)
    labels = torch.where(is_pos, torch.gather(gt_labels.long(), 1, agt), num_classes)
    labels = torch.where(keep, labels, -1)
    stds = torch.tensor(BBOX_STDS, device=rois.device)
    deltas = bbox2delta(rois, _gather_rows(gt_xyxy, agt)) / stds
    return {"rois": rois, "labels": labels, "reg_targets": deltas, "pos": is_pos,
            "valid": keep, "assigned_gt": agt}


def rcnn_loss(cls_logits: torch.Tensor, reg: torch.Tensor, tgt: dict
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Shared2FCBBoxHead's losses over the flat sampled rois: softmax CE
    (background last) and class-specific L1 on the positives, both over the
    valid count."""
    labels, valid = tgt["labels"], tgt["valid"]
    num_classes = reg.shape[1]
    safe = labels.clamp_min(0)
    logp = F.log_softmax(cls_logits.float(), dim=-1)
    ce = -torch.gather(logp, 1, safe[:, None])[:, 0]
    n = valid.sum().clamp_min(1)
    cls_loss = torch.where(valid, ce, 0.0).sum() / n
    cls_reg = torch.gather(reg.float(), 1, safe.clamp(0, num_classes - 1)
                           .view(-1, 1, 1).expand(-1, 1, 4))[:, 0]
    l1 = (cls_reg - tgt["reg_targets"]).abs().sum(-1)
    return cls_loss, torch.where(tgt["pos"], l1, 0.0).sum() / n


def mask_loss(mask_logits: torch.Tensor, rois: torch.Tensor, assigned_gt: torch.Tensor,
              labels: torch.Tensor, pos: torch.Tensor, gt_masks: torch.Tensor,
              mask_stride: int = MASK_STRIDE) -> torch.Tensor:
    """FCNMaskHead's BCE on the gt class's channel, batched: mask_logits (B,
    P, M, M, C); rois (B, P, 4); assigned_gt, labels, pos (B, P); gt_masks
    (B, G, Hs, Ws) at canvas / mask_stride. Targets: each positive's gt mask
    cropped to its roi at M x M by RoIAlign (the roi moved half a stride so
    samples read cell centres) and thresholded at .5. Each image's mean
    over its positives, then the batch mean."""
    B, P, M = mask_logits.shape[:3]
    G = gt_masks.shape[1]
    bidx = (torch.arange(B, device=rois.device)[:, None] * G + assigned_gt).float()
    rois5 = torch.cat([bidx.reshape(-1, 1), (rois.float() - 0.5 * mask_stride).reshape(-1, 4)],
                      dim=1)
    stack = gt_masks.reshape(B * G, *gt_masks.shape[2:])[..., None].float()
    crop = roi_align(stack, rois5, (M, M), 1.0 / mask_stride, sample_num=2)[..., 0]
    tgt = (crop >= 0.5).float().view(B, P, M, M)
    safe = labels.clamp(0, mask_logits.shape[-1] - 1)
    per_class = torch.gather(mask_logits.float(), 4,
                             safe.view(B, P, 1, 1, 1).expand(-1, -1, M, M, 1))[..., 0]
    bce = sigmoid_bce(per_class, tgt).mean(dim=(2, 3))
    per_img = torch.where(pos, bce, 0.0).sum(1) / pos.sum(1).clamp_min(1)
    return per_img.mean()


def mask_rcnn_losses(model: MaskRCNN, images: torch.Tensor, gt_xyxy: torch.Tensor,
                     gt_labels: torch.Tensor, gt_valid: torch.Tensor, gt_masks: torch.Tensor,
                     anchors: torch.Tensor, level_sizes: Sequence[int], u_rpn: torch.Tensor,
                     u_rcnn: torch.Tensor, rpn_samples: int = 256, rcnn_samples: int = 128,
                     proposals: int = 256) -> tuple[torch.Tensor, dict]:
    """The JAX CLI's two-stage train loss on one batch: RPN loss, proposals
    (no gradient), RCNN sampling and the box loss, the mask loss on each
    image's first pos_cap = rcnn_samples / 4 sampled rois (the sampler puts
    every positive there). Returns (total, {rpn_cls, rpn_reg, cls, reg,
    mask, num_pos})."""
    feats = model.features(images)
    rpn_cls, rpn_reg = model.rpn(feats)
    l_rpn_cls, l_rpn_reg = rpn_loss(rpn_cls, rpn_reg, anchors, gt_xyxy, gt_valid, u_rpn,
                                    rpn_samples)
    props, pscore = rpn_proposals(rpn_cls.detach(), rpn_reg.detach(), anchors, level_sizes,
                                  model.canvas, max_per_img=proposals)
    tgt = rcnn_stage(props, pscore > 0, gt_xyxy, gt_labels, gt_valid, model.num_classes,
                     u_rcnn, rcnn_samples)
    cls_logits, reg = model.roi_bbox(feats, rois_flat(tgt["rois"]))
    flat = {k: v.reshape(-1, *v.shape[2:]) for k, v in tgt.items()}
    l_cls, l_reg = rcnn_loss(cls_logits, reg, flat)
    B = images.shape[0]
    pos_cap = max(int(rcnn_samples * 0.25), 1)
    mask_logits = model.roi_mask(feats, rois_flat(tgt["rois"][:, :pos_cap]))
    M = mask_logits.shape[1]
    l_mask = mask_loss(mask_logits.reshape(B, pos_cap, M, M, -1), tgt["rois"][:, :pos_cap],
                       tgt["assigned_gt"][:, :pos_cap], tgt["labels"][:, :pos_cap],
                       tgt["pos"][:, :pos_cap], gt_masks)
    losses = {"rpn_cls": l_rpn_cls, "rpn_reg": l_rpn_reg, "cls": l_cls, "reg": l_reg,
              "mask": l_mask, "num_pos": tgt["pos"].sum()}
    return l_rpn_cls + l_rpn_reg + l_cls + l_reg + l_mask, losses


def sampler_uniforms(generator: torch.Generator, batch: int, anchors: int, candidates: int,
                     device) -> tuple[torch.Tensor, torch.Tensor]:
    """(u_rpn (B, 2, anchors), u_rcnn (B, 2, candidates)): one step's
    sampler priorities from `generator`."""
    return (torch.rand(batch, 2, anchors, generator=generator, device=device),
            torch.rand(batch, 2, candidates, generator=generator, device=device))


# --------------------------------------------------------------------- eval

@torch.no_grad()
def mask_rcnn_decode(cls_logits: torch.Tensor, reg: torch.Tensor, rois: torch.Tensor,
                     canvas: int, score_thr: float = 0.05, iou_thr: float = 0.5,
                     max_per_img: int = 100) -> list[dict]:
    """Second-stage detections (bbox_head.get_det_bboxes) for a batch:
    cls_logits (B, R, C + 1), reg (B, R, C, 4), rois (B, R, 4). Softmax
    scores without the background, the best class's deltas decoded with the
    stds and clipped, scores at or below score_thr zeroed, class-offset
    NMS. Returns numpy dicts with boxes, scores, labels and roi_index."""
    probs = F.softmax(cls_logits.float(), dim=-1)[..., :-1]
    scores, labels = probs.max(dim=-1)
    num_classes = reg.shape[2]
    cls_reg = torch.gather(reg.float(), 2, labels.clamp(0, num_classes - 1)
                           .view(*labels.shape, 1, 1).expand(-1, -1, 1, 4))[:, :, 0]
    boxes = delta2bbox(rois.float(), cls_reg * torch.tensor(BBOX_STDS, device=reg.device),
                       max_shape=(canvas, canvas))
    scores = torch.where(scores > score_thr, scores, 0.0)
    offset = labels.float()[..., None] * 1e5
    keep, valid = batched_nms(boxes + offset, scores, iou_thr, max_per_img)
    ids = torch.arange(boxes.shape[1], device=boxes.device).expand(boxes.shape[0], -1)
    return gather_detections(boxes, scores, labels, ids, keep, valid, score_thr, "roi_index")


# ---------------------------------------------------------------- factories

def _mask_rcnn_efficientvit(name: str, num_classes: int, canvas: int, dtype, device,
                            attn_kernel: str = "cascade", dw_kernel: str = "library", **kw):
    from cream_tpu_torch.models.efficientvit import _CONFIGS
    bb = efficientvit_backbone(name, canvas, dtype=dtype, device=device,
                               attn_kernel=attn_kernel, dw_kernel=dw_kernel)
    return MaskRCNN(bb, _CONFIGS[name]["embed_dim"], canvas, num_classes, dtype=dtype,
                    device=device, **kw)


@register_model
def mask_rcnn_efficientvit_m4(num_classes: int = 80, canvas: int = 512, *, device,
                              dtype=torch.float32, **kw):
    """mask_rcnn_efficientvit_m4_fpn_1x_coco."""
    return _mask_rcnn_efficientvit("efficientvit_m4", num_classes, canvas, dtype, device, **kw)


@register_model
def mask_rcnn_efficientvit_m0(num_classes: int = 80, canvas: int = 512, *, device,
                              dtype=torch.float32, **kw):
    return _mask_rcnn_efficientvit("efficientvit_m0", num_classes, canvas, dtype, device, **kw)
