"""RetinaNet over an EfficientViT-FPN backbone: anchors, the box coder, the
max-IoU assigner, the neck, the head, the loss and the decode.

Counterpart of `cream_tpu/models/retinanet.py` (the reference's
EfficientViT/downstream/configs/retinanet_efficientvit_m4_fpn_1x_coco.py on
the vendored mmdet): mmdet's AnchorGenerator with legacy (w - 1)/2 centres
and rounded base anchors (octave scales 4 * 2^(i/3), ratios {.5, 1, 2},
strides 8..128), the DeltaXYWH coder with legacy +1 sizes, MaxIoUAssigner
(pos >= .5, neg < .4, the gt-max rescue), the EfficientViTFPN neck (1x1
laterals on the backbone's three stages, top-down adds, a 2x2 stride-2
transposed conv for the stride-8 level, 3x3 fpn convs, a stride-2
subsample for the top level) and RetinaHead (4 + 4 shared 3x3 convs, the
sigmoid focal classifier with its prior bias, per-anchor deltas). Maps
are NHWC; anchors are host numpy built once for a canvas.

Parameter names are mmdet's, so a released checkpoint's state_dict loads
as it is: `backbone.*` (the released EfficientViT names),
`neck.lateral_convs.{i}.conv`, `neck.fpn_convs.{i}.conv` (mmcv ConvModule's
`.conv`), `bbox_head.cls_convs.{i}.conv`, `bbox_head.reg_convs.{i}.conv`,
`bbox_head.retina_cls`, `bbox_head.retina_reg`. The reference's
`downstream/efficientvit_fpn.py` is not in this repository: the names of
its transposed-conv extra levels, `neck.extra_trans_convs.{i}` (a bare
ConvTranspose2d) and `neck.extra_fpn_convs.{i}.conv`, follow its mmdet FPN
pattern and are not confirmed against a released file.

The neck differs from the JAX package's flax modules in two places, both
held by the tests: flax's ConvTranspose (kernel 2, stride 2, SAME,
transpose_kernel=False) is torch's ConvTranspose2d with the kernel flipped
in both spatial axes (`zoo.load` flips it), and `jax.image.resize(...,
"nearest")` samples pixel centres, torch's "nearest-exact".
"""
from __future__ import annotations

import copy
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from cream_tpu_torch.models.registry import register_model
from cream_tpu_torch.ops.detection import batched_nms, iou_matrix
from cream_tpu_torch.train.detection import sigmoid_focal_loss

RETINA_STRIDES = (8, 16, 32, 64, 128)
FPN_LEVELS = 5
NUM_ANCHORS = 9                 # RetinaHead: 3 octave scales x 3 ratios a position
# the classifier's prior: p = 0.01 at init (retina_head.py init_weights)
PRIOR_BIAS = -math.log((1 - 0.01) / 0.01)


# ------------------------------------------------------------------ anchors

def gen_base_anchors(base_size: int, scales, ratios) -> np.ndarray:
    """anchor_generator.py:18-43 (legacy centres, rounded)."""
    w = h = float(base_size)
    x_ctr, y_ctr = 0.5 * (w - 1), 0.5 * (h - 1)
    ratios = np.asarray(ratios, np.float32)
    scales = np.asarray(scales, np.float32)
    h_ratios = np.sqrt(ratios)
    w_ratios = 1.0 / h_ratios
    ws = (w * w_ratios[:, None] * scales[None, :]).reshape(-1)
    hs = (h * h_ratios[:, None] * scales[None, :]).reshape(-1)
    return np.round(np.stack([x_ctr - 0.5 * (ws - 1), y_ctr - 0.5 * (hs - 1),
                              x_ctr + 0.5 * (ws - 1), y_ctr + 0.5 * (hs - 1)], axis=-1))


def grid_anchors(base: np.ndarray, feat_h: int, feat_w: int, stride: int) -> np.ndarray:
    """anchor_generator.py:52-68: shifts row-major, anchors fastest."""
    sx = np.arange(feat_w) * stride
    sy = np.arange(feat_h) * stride
    xx = np.tile(sx, feat_h)
    yy = np.repeat(sy, feat_w)
    shifts = np.stack([xx, yy, xx, yy], axis=-1).astype(np.float32)
    return (base[None, :, :] + shifts[:, None, :]).reshape(-1, 4)


def retina_anchors(canvas: int, strides=RETINA_STRIDES, octave_base_scale: int = 4,
                   scales_per_octave: int = 3, ratios=(0.5, 1.0, 2.0)) -> np.ndarray:
    """Every level's anchors for a square canvas, (A, 4) float32."""
    scales = octave_base_scale * np.array([2 ** (i / scales_per_octave)
                                           for i in range(scales_per_octave)])
    out = []
    for s in strides:
        f = -(-canvas // s)
        out.append(grid_anchors(gen_base_anchors(s, scales, ratios), f, f, s))
    return np.concatenate(out, axis=0).astype(np.float32)


def anchors_per_level(canvas: int, strides=RETINA_STRIDES, num_base: int = 9) -> list[int]:
    return [(-(-canvas // s)) ** 2 * num_base for s in strides]


# -------------------------------------------------------------------- coder

def bbox2delta(proposals: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """transforms.py:6-31 (means 0, stds 1, legacy +1 sizes)."""
    px = (proposals[..., 0] + proposals[..., 2]) * 0.5
    py = (proposals[..., 1] + proposals[..., 3]) * 0.5
    pw = proposals[..., 2] - proposals[..., 0] + 1.0
    ph = proposals[..., 3] - proposals[..., 1] + 1.0
    gx = (gt[..., 0] + gt[..., 2]) * 0.5
    gy = (gt[..., 1] + gt[..., 3]) * 0.5
    gw = gt[..., 2] - gt[..., 0] + 1.0
    gh = gt[..., 3] - gt[..., 1] + 1.0
    return torch.stack([(gx - px) / pw, (gy - py) / ph, torch.log(gw / pw),
                        torch.log(gh / ph)], dim=-1)


MAX_RATIO = abs(float(np.log(16 / 1000)))


def delta2bbox(rois: torch.Tensor, deltas: torch.Tensor, max_shape=None) -> torch.Tensor:
    """transforms.py:34-70. The deltas keep their dtype through the clip and
    exp, as JAX keeps a bf16 head's (weak-typed bounds)."""
    dx, dy, dw, dh = deltas.unbind(-1)
    dw = dw.clamp(-MAX_RATIO, MAX_RATIO)
    dh = dh.clamp(-MAX_RATIO, MAX_RATIO)
    px = (rois[..., 0] + rois[..., 2]) * 0.5
    py = (rois[..., 1] + rois[..., 3]) * 0.5
    pw = rois[..., 2] - rois[..., 0] + 1.0
    ph = rois[..., 3] - rois[..., 1] + 1.0
    gw = pw * torch.exp(dw)
    gh = ph * torch.exp(dh)
    gx = px + pw * dx
    gy = py + ph * dy
    x1 = gx - gw * 0.5 + 0.5
    y1 = gy - gh * 0.5 + 0.5
    x2 = gx + gw * 0.5 - 0.5
    y2 = gy + gh * 0.5 - 0.5
    if max_shape is not None:
        x1 = x1.clamp(0, max_shape[1] - 1)
        y1 = y1.clamp(0, max_shape[0] - 1)
        x2 = x2.clamp(0, max_shape[1] - 1)
        y2 = y2.clamp(0, max_shape[0] - 1)
    return torch.stack([x1, y1, x2, y2], dim=-1)


# ----------------------------------------------------------------- assigner

def max_iou_assign(anchors: torch.Tensor, gt_xyxy: torch.Tensor, gt_valid: torch.Tensor,
                   pos_iou_thr: float = 0.5, neg_iou_thr: float = 0.4,
                   min_pos_iou: float = 0.0) -> torch.Tensor:
    """MaxIoUAssigner.assign_wrt_overlaps (max_iou_assigner.py:93-147) in
    the JAX package's static form, batched: anchors (A, 4) or (B, A, 4),
    gts (B, G, 4), valid (B, G) -> (B, A) int64: -2 ignore band, -1
    negative, >= 0 the gt index. Legacy +1 IoU; every anchor tying a gt's
    best IoU takes that gt, a later gt over an earlier one."""
    B, G = gt_valid.shape
    if anchors.ndim == 2:
        anchors = anchors.expand(B, -1, -1)
    ious = torch.stack([iou_matrix(anchors[b], gt_xyxy[b], legacy_plus1=True)
                        for b in range(B)])                          # (B, A, G)
    ious = torch.where(gt_valid[:, None, :], ious, -1.0)
    max_iou, argmax = ious.max(dim=2)
    assigned = torch.full_like(argmax, -2)
    assigned = torch.where((max_iou >= 0) & (max_iou < neg_iou_thr), -1, assigned)
    assigned = torch.where(max_iou >= pos_iou_thr, argmax, assigned)
    gt_max = ious.max(dim=1, keepdim=True).values                   # (B, 1, G)
    is_gt_best = ((ious == gt_max) & (gt_max >= min_pos_iou) & gt_valid[:, None, :]
                  & (gt_max > 0))
    gidx = torch.arange(G, device=ious.device)
    best_gt = torch.where(is_gt_best, gidx, -1).amax(dim=2) if G else \
        torch.full_like(assigned, -1)
    return torch.where(best_gt >= 0, best_gt, assigned)


# ------------------------------------------------------------------ modules

def conv_nhwc(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """`conv` (with its bias) on the NHWC map x in `dtype`, through the
    NCHW view (channels_last strides)."""
    bias = None if conv.bias is None else conv.bias.to(dtype)
    return F.conv2d(x.to(dtype).permute(0, 3, 1, 2), conv.weight.to(dtype), bias, conv.stride,
                    conv.padding, conv.dilation, conv.groups).permute(0, 2, 3, 1)


def conv_transpose_nhwc(conv: nn.ConvTranspose2d, x: torch.Tensor,
                        dtype: torch.dtype) -> torch.Tensor:
    return F.conv_transpose2d(x.to(dtype).permute(0, 3, 1, 2), conv.weight.to(dtype),
                              conv.bias.to(dtype), conv.stride).permute(0, 2, 3, 1)


class ConvModule(nn.Module):
    """mmcv's ConvModule without norm: a biased conv held as `.conv`, and
    a ReLU after it where `act`."""

    def __init__(self, cin: int, cout: int, kernel: int, padding: int = 0, act: bool = False,
                 *, dtype: torch.dtype, device):
        super().__init__()
        self.dtype, self.act = dtype, act
        self.conv = nn.Conv2d(cin, cout, kernel, padding=padding, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv_nhwc(self.conv, x, self.dtype)
        return torch.relu(y) if self.act else y


def resize_nearest(x: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """`jax.image.resize(x, ..., "nearest")` of an NHWC map: pixel centres."""
    if tuple(x.shape[1:3]) == tuple(hw):
        return x
    return F.interpolate(x.permute(0, 3, 1, 2), size=hw, mode="nearest-exact") \
        .permute(0, 2, 3, 1)


class EfficientViTFPN(nn.Module):
    """efficientvit_fpn.py's forward (:190-264): laterals, top-down adds,
    `num_extra_trans_convs` 2x transposed convs below the finest lateral
    with a 3x3 conv each, 3x3 fpn convs, stride-2 subsampling (a 1x1
    max-pool) up to `FPN_LEVELS` levels. Returns the levels finest first."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 num_extra_trans_convs: int = 1, *, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.dtype = dtype
        self.lateral_convs = nn.ModuleList(ConvModule(c, out_channels, 1, **kw)
                                           for c in in_channels)
        self.extra_trans_convs = nn.ModuleList(
            nn.ConvTranspose2d(out_channels, out_channels, 2, 2, device=device)
            for _ in range(num_extra_trans_convs))
        self.fpn_convs = nn.ModuleList(ConvModule(out_channels, out_channels, 3, 1, **kw)
                                       for _ in in_channels)
        self.extra_fpn_convs = nn.ModuleList(ConvModule(out_channels, out_channels, 3, 1, **kw)
                                             for _ in range(num_extra_trans_convs))

    def forward(self, feats: Sequence[torch.Tensor]) -> tuple[torch.Tensor, ...]:
        n = len(feats)
        laterals = [conv(f) for conv, f in zip(self.lateral_convs, feats)]
        for i in range(n - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + resize_nearest(laterals[i],
                                                               laterals[i - 1].shape[1:3])
        extra, prev = [], laterals[0]
        for t in self.extra_trans_convs:
            prev = conv_transpose_nhwc(t, prev, self.dtype)
            extra.insert(0, prev)
        outs = [conv(lat) for conv, lat in zip(self.fpn_convs, laterals)]
        while len(outs) + len(extra) < FPN_LEVELS:
            outs.append(outs[-1][:, ::2, ::2])
        return tuple([conv(t) for conv, t in zip(self.extra_fpn_convs, extra)] + outs)


class RetinaHead(nn.Module):
    """retina_head.py: 4 shared 3x3 conv+ReLU towers for classes and boxes,
    the sigmoid classifier (bias at the 0.01 prior) and the 4-delta
    regressor, applied to every level. Returns (cls (B, A, C), deltas (B,
    A, 4)), anchors fastest within a position."""

    def __init__(self, num_classes: int = 80, in_channels: int = 256, feat_channels: int = 256,
                 *, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.dtype, self.num_classes = dtype, num_classes

        def tower():
            return nn.ModuleList(ConvModule(in_channels if i == 0 else feat_channels,
                                            feat_channels, 3, 1, True, **kw) for i in range(4))
        self.cls_convs, self.reg_convs = tower(), tower()
        self.retina_cls = nn.Conv2d(feat_channels, NUM_ANCHORS * num_classes, 3, padding=1,
                                    device=device)
        self.retina_reg = nn.Conv2d(feat_channels, NUM_ANCHORS * 4, 3, padding=1, device=device)
        nn.init.constant_(self.retina_cls.bias, PRIOR_BIAS)

    def forward(self, feats: Sequence[torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
        cls_out, reg_out = [], []
        for f in feats:
            c = r = f
            for conv in self.cls_convs:
                c = conv(c)
            for conv in self.reg_convs:
                r = conv(r)
            B = f.shape[0]
            cls_out.append(conv_nhwc(self.retina_cls, c, self.dtype).reshape(B, -1,
                                                                             self.num_classes))
            reg_out.append(conv_nhwc(self.retina_reg, r, self.dtype).reshape(B, -1, 4))
        return torch.cat(cls_out, dim=1), torch.cat(reg_out, dim=1)


def backbone_channels(make_backbone, canvas: int) -> list[int]:
    """The channels of a backbone's `forward_pyramid` levels at `canvas`,
    from a copy built and run on the meta device."""
    bb = make_backbone("meta").eval()
    with torch.no_grad():
        feats = bb.forward_pyramid(torch.empty(1, canvas, canvas, 3, device="meta"))
    return [f.shape[-1] for f in feats]


class RetinaNet(nn.Module):
    """backbone.forward_pyramid -> EfficientViTFPN -> RetinaHead on (B,
    canvas, canvas, 3) NHWC images: (cls logits (B, A, C), deltas (B, A,
    4)) in `dtype`; the anchors are `retina_anchors(canvas)`.
    `fpn_extra_trans`: 1 for a stride-16/32/64 backbone (EfficientViT), 0
    for a stride-8/16/32 one (Cream, CDARTS); both give P3-P7. Train mode
    (`model.train()`) is the JAX package's `train=True`."""

    def __init__(self, backbone: nn.Module, in_channels: Sequence[int], canvas: int,
                 num_classes: int = 80, fpn_channels: int = 256, fpn_extra_trans: int = 1, *,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.num_classes, self.dtype = num_classes, dtype
        self.img_size = self.canvas = canvas
        self.backbone = backbone
        self.neck = EfficientViTFPN(in_channels, fpn_channels, fpn_extra_trans, **kw)
        self.bbox_head = RetinaHead(num_classes, fpn_channels, fpn_channels, **kw)
        # an EfficientViT backbone's seeded-weights rule (zoo.load.seeded_state_dict)
        self.SEEDED_BRANCH_SCALE = getattr(backbone, "SEEDED_BRANCH_SCALE", 1.0)
        self.SEEDED_BRANCH_ENDS = getattr(backbone, "SEEDED_BRANCH_ENDS", ())

    def features(self, images: torch.Tensor) -> tuple[torch.Tensor, ...]:
        return self.neck(self.backbone.forward_pyramid(images))

    def forward(self, images: torch.Tensor, generator: torch.Generator | None = None):
        """`generator` is taken for the train step's interface; the model
        draws nothing."""
        return self.bbox_head(self.features(images))


# ------------------------------------------------------------------- losses

def retinanet_loss(cls_logits: torch.Tensor, deltas: torch.Tensor, anchors: torch.Tensor,
                   gt_xyxy: torch.Tensor, gt_labels: torch.Tensor, gt_valid: torch.Tensor,
                   num_classes: int | None = None) -> dict:
    """Focal + L1 with mmdet's Retina targets (anchor_head.py's loss,
    sampling=False): 1-based labels for the focal kernel (0 background), the
    ignore band out of both losses, each image's sums over its positive
    count (at least 1), then the batch mean. 'num_pos' is the batch's
    positive count."""
    assigned = max_iou_assign(anchors, gt_xyxy, gt_valid)                # (B, A)
    pos = assigned >= 0
    safe = assigned.clamp_min(0)
    tgt_label = torch.where(pos, torch.gather(gt_labels.long(), 1, safe) + 1, 0)
    tgt_label = torch.where(assigned == -2, -1, tgt_label)
    focal = sigmoid_focal_loss(cls_logits.float(), tgt_label)
    num_pos = pos.sum(1).float().clamp_min(1.0)
    cls_loss = focal.sum(dim=(1, 2)) / num_pos
    tgt = torch.gather(gt_xyxy, 1, safe[..., None].expand(-1, -1, 4))
    tgt_delta = bbox2delta(anchors.expand_as(tgt), tgt)
    l1 = (deltas.float() - tgt_delta).abs().sum(-1)
    box_loss = torch.where(pos, l1, 0.0).sum(1) / num_pos
    return {"loss_cls": cls_loss.mean(), "loss_bbox": box_loss.mean(), "num_pos": pos.sum()}


def topk_stable(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest along the last dim, the lower index first
    among equal values (`lax.top_k`'s order)."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


def retinanet_decode(cls_logits: torch.Tensor, deltas: torch.Tensor, anchors: torch.Tensor,
                     level_sizes: Sequence[int], score_thr: float = 0.05, nms_pre: int = 1000,
                     iou_thr: float = 0.5, max_per_img: int = 100) -> list[dict]:
    """Per-image detections, anchor_head.get_bboxes as the JAX package
    computes them: per level the top nms_pre anchors by their best class
    probability, decoded; scores at or below score_thr zeroed; class-wise
    NMS through the class-offset trick (label * 1e5 added to the boxes, in
    fp32); the top max_per_img kept, those above score_thr returned. One
    NMS over the batch (`batched_nms`). Returns numpy dicts (boxes xyxy,
    scores, labels, and the anchor each came from)."""
    probs = torch.sigmoid(cls_logits.float())
    boxes_l, scores_l, labels_l, ids_l = [], [], [], []
    off = 0
    for n in level_sizes:
        p = probs[:, off:off + n]                                     # (B, n, C)
        idx = topk_stable(p.amax(dim=2), min(nms_pre, n))             # (B, k)
        pk = torch.gather(p, 1, idx[..., None].expand(-1, -1, p.shape[2]))
        d = torch.gather(deltas[:, off:off + n], 1, idx[..., None].expand(-1, -1, 4))
        boxes_l.append(delta2bbox(anchors[off:off + n][idx], d))
        s, lab = pk.max(dim=2)
        scores_l.append(s)
        labels_l.append(lab)
        ids_l.append(idx + off)
        off += n
    boxes, scores, labels = torch.cat(boxes_l, 1), torch.cat(scores_l, 1), torch.cat(labels_l, 1)
    scores = torch.where(scores > score_thr, scores, 0.0)
    offset = labels.float()[..., None] * 1e5
    keep, valid = batched_nms(boxes + offset, scores, iou_thr, max_per_img)
    return gather_detections(boxes, scores, labels, torch.cat(ids_l, 1), keep, valid,
                             score_thr, "anchor")


def gather_detections(boxes, scores, labels, ids, keep, valid, score_thr: float,
                      id_key: str) -> list[dict]:
    """Each image's kept detections above score_thr as numpy (boxes,
    scores, labels, and `ids` under `id_key`: the anchor or roi each came
    from); one transfer a field."""
    b = torch.gather(boxes, 1, keep[..., None].expand(-1, -1, 4)).cpu().numpy()
    s = torch.gather(scores, 1, keep).cpu().numpy()
    lab = torch.gather(labels, 1, keep).cpu().numpy()
    k = torch.gather(ids, 1, keep).cpu().numpy()
    v = valid.cpu().numpy()
    out = []
    for i in range(len(b)):
        sel = v[i] & (s[i] > score_thr)
        out.append({"boxes": b[i][sel], "scores": s[i][sel], "labels": lab[i][sel],
                    id_key: k[i][sel]})
    return out


# ------------------------------------------------------- depthwise sites

def dw3x3_sites(model: nn.Module, batch: int) -> list[tuple[int, tuple[int, ...]]]:
    """(stride, NHWC input shape) of every depthwise 3x3 ConvBN call one
    train-mode forward of a detector's backbone makes at `batch`, in order,
    repeats kept. Traced on the meta device (no data, no kernel); in train
    mode the attention runs its plain route, so its k3 query convs are
    sites (in eval the K4 route folds them)."""
    from cream_tpu_torch.nn.layers import ConvBN, set_dw_kernel
    meta = copy.deepcopy(model.backbone).to("meta").train()
    set_dw_kernel(meta, "library")              # no kernel runs on the meta device
    sites = []

    def hook(mod, inputs):
        if mod.is_dw3x3():
            sites.append((mod.stride, tuple(inputs[0].shape)))
    for m in meta.modules():
        if isinstance(m, ConvBN):
            m.register_forward_pre_hook(hook)
    c = model.canvas
    meta.forward_pyramid(torch.zeros(batch, c, c, 3, device="meta"))
    return sites


def dw3x3_step_launches(model: nn.Module, batch: int) -> dict:
    """K7/K9 launches of one detector train step on `"fused"`
    (`dwconv.LAUNCHES`' keys): each site of `dw3x3_sites` once forward and
    once backward, where the kernel takes its shape (`dwconv.supports_fused`
    / `supports_fused_s2`; a site it refuses runs the library conv and is
    counted in `nn.layers.DW_REFUSED`)."""
    from cream_tpu_torch.ops import dwconv
    s1 = sum(s == 1 and dwconv.supports_fused(shape) for s, shape in dw3x3_sites(model, batch))
    s2 = sum(s == 2 and dwconv.supports_fused_s2(shape)
             for s, shape in dw3x3_sites(model, batch))
    return {"k7_fwd": s1, "k7_bwd": s1, "k8": 0, "k9_fwd": s2, "k9_bwd": s2}


# ---------------------------------------------------------------- factories

def efficientvit_backbone(name: str, canvas: int, *, dtype, device, **kw):
    """A released EfficientViT config as a detection backbone: no head,
    the classifier's img_size (224) for its stage resolutions, `canvas` for
    its maps (the windows JAX picks at that canvas)."""
    from cream_tpu_torch.models.efficientvit import _CONFIGS, EfficientViT
    return EfficientViT(num_classes=0, canvas=canvas, dtype=dtype, device=device,
                        **_CONFIGS[name], **kw)


def headless(backbone: nn.Module, *heads: str) -> nn.Module:
    """`backbone` without its classifier modules, which a detector never
    runs (the JAX package's detectors have no params for them)."""
    for name in heads:
        setattr(backbone, name, None)
    return backbone


def _retinanet_efficientvit(name: str, num_classes: int, canvas: int, dtype, device,
                            attn_kernel: str = "cascade", dw_kernel: str = "library", **kw):
    from cream_tpu_torch.models.efficientvit import _CONFIGS
    bb = efficientvit_backbone(name, canvas, dtype=dtype, device=device,
                               attn_kernel=attn_kernel, dw_kernel=dw_kernel)
    return RetinaNet(bb, _CONFIGS[name]["embed_dim"], canvas, num_classes, dtype=dtype,
                     device=device, **kw)


@register_model
def retinanet_efficientvit_m4(num_classes: int = 80, canvas: int = 512, *, device,
                              dtype=torch.float32, **kw):
    """retinanet_efficientvit_m4_fpn_1x_coco."""
    return _retinanet_efficientvit("efficientvit_m4", num_classes, canvas, dtype, device, **kw)


@register_model
def retinanet_efficientvit_m0(num_classes: int = 80, canvas: int = 512, *, device,
                              dtype=torch.float32, **kw):
    return _retinanet_efficientvit("efficientvit_m0", num_classes, canvas, dtype, device, **kw)


@register_model
def retinanet_cream(arch="cream_604", num_classes: int = 80, canvas: int = 512, *, device,
                    dtype=torch.float32, dw_kernel: str = "library", **kw):
    """RetinaNet over a Cream childnet (the CDARTS_detection composition of
    a NAS mobile backbone with mmdet's FPN + RetinaNet). `arch`: a released
    name (cream_14 .. cream_604), per-stage choice tuples, or the flat
    supernet form out of a search."""
    from cream_tpu_torch.models.cream import RELEASED_CHILDNETS, CreamChildNet, nest_arch
    released = isinstance(arch, str)
    if released:
        arch = RELEASED_CHILDNETS[arch]
    else:
        arch = tuple(arch)
        if arch and not isinstance(arch[0], (tuple, list)):
            arch = nest_arch(arch)
        arch = tuple(tuple(s) for s in arch)

    def make(dev):
        return headless(CreamChildNet(arch, released_quirk=released, dtype=dtype,
                                      dw_kernel=dw_kernel, device=dev), "conv_head", "classifier")
    return RetinaNet(make(device), backbone_channels(make, canvas), canvas, num_classes,
                     fpn_extra_trans=0, dtype=dtype, device=device, **kw)


@register_model
def retinanet_cdarts(genotypes, num_classes: int = 80, canvas: int = 512, *, device,
                     dtype=torch.float32, init_channels: int = 48, dw_kernel: str = "library",
                     **kw):
    """RetinaNet over a CDARTS retrain backbone (per-group genotypes, as in
    cdarts_retrain_imagenet's cells JSON)."""
    from cream_tpu_torch.models.darts import CDARTSRetrain, as_genotypes
    if isinstance(genotypes, dict):
        genotypes = [genotypes[k] for k in sorted(genotypes, key=int)]
    genotypes = as_genotypes(genotypes)

    def make(dev):
        return headless(CDARTSRetrain(genotypes, model_type="imagenet",
                                      init_channels=init_channels, dtype=dtype,
                                      dw_kernel=dw_kernel, device=dev), "fc")
    return RetinaNet(make(device), backbone_channels(make, canvas), canvas, num_classes,
                     fpn_extra_trans=0, dtype=dtype, device=device, **kw)
