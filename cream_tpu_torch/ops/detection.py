"""Detection ops: IoU, NMS, RoIAlign, Soft-NMS, RoIPool, deformable and
masked convolution, NHWC.

Counterpart of `cream_tpu/ops/detection.py`, which rebuilds the mmdet CUDA
ops the reference vendors (CDARTS/CDARTS_detection/mmdet/ops/*) as XLA
programs. No Pallas kernel lies under any of them; here they are plain
PyTorch on whatever device their tensors are on.

  * `nms`: greedy NMS with the JAX package's fixed-size result (indices into
    the original boxes, kept ones first in descending score, then the first
    suppressed ones by score rank, and a validity mask). The (N, N)
    suppression matrix is built on the device in fp32 with the JAX
    package's IoU arithmetic, op for op (the class-offset trick puts boxes
    near 8e6, where fp32 resolves 0.5, so another formula moves decisions
    at the threshold), packed to bits there, and swept greedily on the host
    in one pass, as the mmdet CUDA kernel's host loop does: a few launches
    and one transfer an image, not a launch per box.
  * `roi_align`: the mmdet kernel's semantics as the JAX package documents
    them (legacy +1 ends, samples at (i + .5)/n of a bin, zero outside
    (-1, H] x (-1, W], the kernel's clamping), one gather of the four
    corners of every sample; its gradient comes from autograd.
    `roi_align_levels` aligns each roi on its own level of a pyramid,
    computing only that level.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def iou_matrix(a: torch.Tensor, b: torch.Tensor, legacy_plus1: bool = False) -> torch.Tensor:
    """(N, 4) x (M, 4) xyxy -> (N, M) IoU, op for op the JAX package's."""
    off = 1.0 if legacy_plus1 else 0.0

    def area(x):
        return (x[:, 2] - x[:, 0] + off) * (x[:, 3] - x[:, 1] + off)
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt + off).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area(a)[:, None] + area(b)[None, :] - inter)


def _suppression_bits(boxes: torch.Tensor, iou_threshold: float,
                      legacy_plus1: bool) -> torch.Tensor:
    """(N, 4) boxes in score order -> (N, ceil(N/8)) uint8 rows on the
    device: bit j of row i set where box j (j > i) overlaps box i above the
    threshold (little-endian bits, so a row reads as one integer)."""
    n = boxes.shape[0]
    sup = iou_matrix(boxes, boxes, legacy_plus1) > iou_threshold
    sup &= torch.ones(n, n, dtype=torch.bool, device=boxes.device).triu(1)
    pad = (-n) % 8
    if pad:
        sup = F.pad(sup, (0, pad))
    weights = (1 << torch.arange(8, device=boxes.device)).to(torch.uint8)
    return (sup.view(n, -1, 8).to(torch.uint8) * weights).sum(-1, dtype=torch.uint8)


def _greedy_sweep(rows: np.ndarray, n: int, max_outputs: int) -> tuple[np.ndarray, np.ndarray]:
    """The JAX scan's result from the packed suppression rows: (rank in the
    score order (min(n, max_outputs),), valid). Kept boxes come first in
    score order; if fewer than max_outputs are kept, the first suppressed
    ones follow, marked invalid."""
    removed, kept = 0, []
    for i in range(n):
        if removed >> i & 1:
            continue
        kept.append(i)
        if len(kept) == max_outputs:
            break
        removed |= int.from_bytes(rows[i].tobytes(), "little")
    k = min(n, max_outputs)
    if len(kept) < k:
        dropped = [i for i in range(n) if removed >> i & 1][:k - len(kept)]
        rank = np.asarray(kept + dropped, np.int64)
    else:
        rank = np.asarray(kept, np.int64)
    valid = np.zeros(k, bool)
    valid[:len(kept)] = True
    return rank, valid


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
                max_outputs: int, legacy_plus1: bool = False
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """`nms` of each of B box sets (B, N, 4) / (B, N): (indices (B, K), valid
    (B, K)) with K = min(N, max_outputs), on the boxes' device. The B
    suppression matrices cross to the host in one transfer."""
    B, n = scores.shape
    order = torch.sort(-scores, dim=1, stable=True).indices
    sboxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    rows = torch.stack([_suppression_bits(sboxes[b], iou_threshold, legacy_plus1)
                        for b in range(B)]).cpu().numpy()
    ranks, valids = zip(*(_greedy_sweep(rows[b], n, max_outputs) for b in range(B)))
    rank = torch.from_numpy(np.stack(ranks)).to(boxes.device)
    valid = torch.from_numpy(np.stack(valids)).to(boxes.device)
    return torch.gather(order, 1, rank), valid


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
        max_outputs: int, legacy_plus1: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS, the JAX package's `nms`: (indices (K,) into the original
    boxes, valid (K,) bool), K = min(N, max_outputs), highest score first;
    among equal scores the lower index ranks first (a stable sort). Box i
    suppresses a later box j where IoU > threshold and i is itself kept."""
    idx, valid = batched_nms(boxes[None], scores[None], iou_threshold, max_outputs,
                             legacy_plus1)
    return idx[0], valid[0]


def _sample_points(rois: torch.Tensor, scale: torch.Tensor | float, out_size, sample_num: int,
                   legacy_plus1: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """(grid_y (R, ph, s), grid_x (R, pw, s)) in map coordinates, as the
    JAX package computes them."""
    ph, pw = out_size
    off = 1.0 if legacy_plus1 else 0.0
    x1 = rois[:, 1] * scale
    y1 = rois[:, 2] * scale
    x2 = (rois[:, 3] + off) * scale
    y2 = (rois[:, 4] + off) * scale
    roi_w = (x2 - x1).clamp_min(0.0)
    roi_h = (y2 - y1).clamp_min(0.0)
    bin_h = roi_h / ph
    bin_w = roi_w / pw
    dev = rois.device
    iy = (torch.arange(sample_num, device=dev, dtype=torch.float32) + 0.5) / sample_num
    ay = torch.arange(ph, device=dev, dtype=torch.float32)[None, :, None] + iy[None, None, :]
    ax = torch.arange(pw, device=dev, dtype=torch.float32)[None, :, None] + iy[None, None, :]
    return (y1[:, None, None] + ay * bin_h[:, None, None],
            x1[:, None, None] + ax * bin_w[:, None, None])


def _axis_taps(g: torch.Tensor, size: torch.Tensor) -> tuple:
    """The kernel's clamping along one axis: (low, high, weight of low,
    weight of high, inside) for sample coordinates g against map sizes
    `size` (broadcast)."""
    inside = (g >= -1.0) & (g <= size)
    g = g.clamp_min(0.0)
    low = torch.minimum(g.to(torch.int64), size - 1)
    g = torch.where(low >= size - 1, low.to(g.dtype), g)
    high = torch.minimum(low + 1, size - 1)
    lg = g - low
    return low, high, 1.0 - lg, lg, inside


def _align(flat: torch.Tensor, base: torch.Tensor, H: torch.Tensor, W: torch.Tensor,
           gy: torch.Tensor, gx: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of a flattened (rows, C) map stack: roi r reads the
    (H[r], W[r]) map starting at row base[r]; gy (R, ph, s), gx (R, pw, s).
    Returns (R, ph, pw, C) fp32, the mean over each bin's s x s samples."""
    R, ph, s = gy.shape
    pw = gx.shape[1]
    Hr, Wr = H.view(R, 1, 1), W.view(R, 1, 1)
    yl, yh, hy, ly, iny = _axis_taps(gy, Hr)                      # (R, ph, s)
    xl, xh, hx, lx, inx = _axis_taps(gx, Wr)                      # (R, pw, s)
    Y = (R, ph, 1, s, 1)
    X = (R, 1, pw, 1, s)
    rowb = base.view(R, 1, 1, 1, 1)
    Wv = W.view(R, 1, 1, 1, 1)

    def tap(yy, xx):
        idx = rowb + yy.view(Y) * Wv + xx.view(X)
        return flat[idx.reshape(-1)].view(R, ph, pw, s, s, -1).float()
    wy = (hy.view(Y), ly.view(Y))
    wx = (hx.view(X), lx.view(X))
    val = ((wy[0] * wx[0])[..., None] * tap(yl, xl)
           + (wy[0] * wx[1])[..., None] * tap(yl, xh)
           + (wy[1] * wx[0])[..., None] * tap(yh, xl)
           + (wy[1] * wx[1])[..., None] * tap(yh, xh))
    inside = iny.view(Y) & inx.view(X)
    val = torch.where(inside[..., None], val, 0.0)
    return val.mean(dim=(3, 4))


def roi_align(features: torch.Tensor, rois: torch.Tensor, out_size, spatial_scale: float,
              sample_num: int = 2, legacy_plus1: bool = True) -> torch.Tensor:
    """features (B, H, W, C) NHWC; rois (R, 5) [batch_idx, x1, y1, x2, y2] in
    input-image coordinates. Returns (R, ph, pw, C) in fp32 (the JAX
    package's result type: fp32 sample weights times the features).

    legacy_plus1=True is the vendored mmdet convention (roi_end = (coord + 1)
    * scale); False the aligned=False torchvision one. sample_num must be >
    0 (the configs use 2)."""
    if sample_num <= 0:
        raise ValueError("roi_align: the adaptive sample_num=0 is not supported")
    B, H, W, C = features.shape
    rois = rois.float()
    R = rois.shape[0]
    gy, gx = _sample_points(rois, spatial_scale, out_size, sample_num, legacy_plus1)
    b = rois[:, 0].to(torch.int64)
    dev = rois.device
    hw = torch.full((R,), H, dtype=torch.int64, device=dev), \
        torch.full((R,), W, dtype=torch.int64, device=dev)
    return _align(features.reshape(B * H * W, C), b * (H * W), *hw, gy, gx)


def roi_levels(rois: torch.Tensor, num_levels: int, finest_scale: float = 56.0) -> torch.Tensor:
    """SingleRoIExtractor's level of each roi: clamp(floor(log2(sqrt(w*h) /
    finest_scale + 1e-6)), 0, num_levels - 1) with legacy +1 sizes."""
    w = rois[:, 3] - rois[:, 1] + 1
    h = rois[:, 4] - rois[:, 2] + 1
    scale = torch.sqrt((w * h).clamp_min(1e-6))
    return torch.floor(torch.log2(scale / finest_scale + 1e-6)).clamp(0, num_levels - 1) \
        .to(torch.int64)


def roi_align_levels(feats, rois: torch.Tensor, out_size, strides, sample_num: int = 2,
                     legacy_plus1: bool = True) -> torch.Tensor:
    """Multi-level RoIAlign: roi r is aligned on feats[roi_levels(r)] only
    (the JAX package aligns every level densely and masks; the values are
    the same). feats: NHWC maps of one batch at `strides`. One gather over
    the levels flattened together; no host sync. Returns (R, ph, pw, C) fp32."""
    rois = rois.float()
    lvl = roi_levels(rois, len(strides))
    dev = rois.device
    sizes = [(f.shape[1], f.shape[2]) for f in feats]
    starts = np.cumsum([0] + [f.shape[0] * h * w for f, (h, w) in zip(feats, sizes)])[:-1]
    flat = torch.cat([f.reshape(-1, f.shape[-1]) for f in feats])

    def per_roi(vals, dtype):
        return torch.tensor(vals, dtype=dtype, device=dev)[lvl]
    H = per_roi([h for h, _ in sizes], torch.int64)
    W = per_roi([w for _, w in sizes], torch.int64)
    scale = per_roi([1.0 / s for s in strides], torch.float32)
    base = per_roi([int(s) for s in starts], torch.int64) + rois[:, 0].to(torch.int64) * H * W
    gy, gx = _sample_points(rois, scale, out_size, sample_num, legacy_plus1)
    return _align(flat, base, H, W, gy, gx)


def soft_nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
             method: str = "linear", sigma: float = 0.5, min_score: float = 1e-3,
             max_out: int | None = None) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Soft-NMS (mmdet soft_nms_cpu.pyx) in the JAX package's fixed-size
    form: (order (steps,) input indices in selection order, -1 where
    exhausted; their decayed scores; count). Legacy +1 boxes. A host loop of
    `steps` device iterations, as the pyx's."""
    n = boxes.shape[0]
    steps = n if max_out is None else min(max_out, n)
    x1, y1, x2, y2 = boxes.unbind(1)
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    cur = scores.float().clone()
    valid = torch.ones(n, dtype=torch.bool, device=boxes.device)
    order = torch.full((steps,), -1, dtype=torch.int64, device=boxes.device)
    out_scores = torch.zeros(steps, dtype=torch.float32, device=boxes.device)
    neg_inf = torch.tensor(-float("inf"), device=boxes.device)
    for i in range(steps):
        sel = torch.argmax(torch.where(valid, cur, neg_inf))
        any_valid = valid.any()
        order[i] = torch.where(any_valid, sel, -1)
        out_scores[i] = torch.where(any_valid, cur[sel], 0.0)
        valid[sel] = False
        iw = torch.minimum(x2[sel], x2) - torch.maximum(x1[sel], x1) + 1
        ih = torch.minimum(y2[sel], y2) - torch.maximum(y1[sel], y1) + 1
        inter = iw.clamp_min(0) * ih.clamp_min(0)
        ov = inter / (areas[sel] + areas - inter)
        ov = torch.where((iw > 0) & (ih > 0), ov, 0.0)
        if method == "linear":
            w = torch.where(ov > iou_threshold, 1.0 - ov, 1.0)
        elif method == "gaussian":
            w = torch.exp(-(ov * ov) / sigma)
        else:                                                   # hard nms
            w = torch.where(ov > iou_threshold, 0.0, 1.0)
        w = torch.where(any_valid & valid, w, 1.0)
        cur = cur * w
        valid = valid & (cur >= min_score)
    return order, out_scores, int((order >= 0).sum())


def roi_pool(features: torch.Tensor, rois: torch.Tensor, out_size,
             spatial_scale: float = 1.0) -> torch.Tensor:
    """RoI max-pool (mmdet roi_pool_kernel.cu), NHWC, the JAX package's
    static-binned form: each bin's integer bounds (floor / ceil of its
    fractional edges, clipped to the map) become row and column masks and
    the bin is the max over them; an empty bin or a malformed roi (w or h
    <= 0) gives 0. Returns (R, ph, pw, C) in the features' dtype."""
    B, H, W, C = features.shape
    ph, pw = out_size
    rois = rois.float()
    dev = rois.device
    b = rois[:, 0].to(torch.int64)
    x1 = rois[:, 1] * spatial_scale
    y1 = rois[:, 2] * spatial_scale
    roi_w = (rois[:, 3] + 1) * spatial_scale - x1
    roi_h = (rois[:, 4] + 1) * spatial_scale - y1
    ok = (roi_w > 0) & (roi_h > 0)
    bw, bh = roi_w / pw, roi_h / ph
    py = torch.arange(ph, dtype=torch.float32, device=dev)
    px = torch.arange(pw, dtype=torch.float32, device=dev)
    y1b = torch.floor(py * bh[:, None] + y1[:, None]).clamp(0, H).to(torch.int64)
    y2b = torch.ceil((py + 1) * bh[:, None] + y1[:, None]).clamp(0, H).to(torch.int64)
    x1b = torch.floor(px * bw[:, None] + x1[:, None]).clamp(0, W).to(torch.int64)
    x2b = torch.ceil((px + 1) * bw[:, None] + x1[:, None]).clamp(0, W).to(torch.int64)
    rows = torch.arange(H, device=dev)
    cols = torch.arange(W, device=dev)
    ymask = (rows >= y1b[..., None]) & (rows < y2b[..., None])          # (R, ph, H)
    xmask = (cols >= x1b[..., None]) & (cols < x2b[..., None])          # (R, pw, W)
    m = ymask[:, :, None, :, None] & xmask[:, None, :, None, :]         # (R, ph, pw, H, W)
    img = features[b].float()                                            # (R, H, W, C)
    vals = torch.where(m[..., None], img[:, None, None], -float("inf"))
    out = vals.amax(dim=(3, 4))
    out = torch.where(torch.isfinite(out), out, 0.0)
    return torch.where(ok[:, None, None, None], out, 0.0).to(features.dtype)


def _bilinear_taps(img2d: torch.Tensor, H: int, W: int, y: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """img2d (H*W, C); y/x (...,) points; deformable_im2col_bilinear
    semantics (zero outside (-1, H) x (-1, W), zero-padded corners)."""
    inside = (y > -1.0) & (y < H) & (x > -1.0) & (x < W)
    y0, x0 = torch.floor(y), torch.floor(x)
    ly, lx = y - y0, x - x0
    y0i, x0i = y0.to(torch.int64), x0.to(torch.int64)

    def tap(yy, xx, w):
        ok = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
        idx = yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)
        v = img2d[idx.reshape(-1)].reshape(*idx.shape, -1)
        return v * (w * ok)[..., None]
    val = (tap(y0i, x0i, (1 - ly) * (1 - lx)) + tap(y0i, x0i + 1, (1 - ly) * lx)
           + tap(y0i + 1, x0i, ly * (1 - lx)) + tap(y0i + 1, x0i + 1, ly * lx))
    return val * inside[..., None]


def deform_conv2d(x: torch.Tensor, offset: torch.Tensor, weight: torch.Tensor,
                  mask: torch.Tensor | None = None, stride: int = 1, padding: int = 1,
                  dilation: int = 1, deformable_groups: int = 1) -> torch.Tensor:
    """Deformable convolution (v1; modulated v2 with `mask`), NHWC, the
    vendored mmdet deformable_im2col's sampling then one contraction with
    the weights; grads by autograd.

    x (B, H, W, C); offset (B, Ho, Wo, dg*kh*kw*2), per group (tap, (dy, dx));
    weight HWIO (kh, kw, C, O), as the JAX package takes it; mask (B, Ho,
    Wo, dg*kh*kw) multiplies the samples (apply the sigmoid before)."""
    B, H, W, C = x.shape
    kh, kw, wc, O = weight.shape
    if wc != C:
        raise ValueError(f"deform_conv2d: weight takes {wc} channels, x has {C}")
    dg, K = deformable_groups, kh * kw
    Ho = (H + 2 * padding - (dilation * (kh - 1) + 1)) // stride + 1
    Wo = (W + 2 * padding - (dilation * (kw - 1) + 1)) // stride + 1
    off = offset.reshape(B, Ho, Wo, dg, K, 2)
    dev = x.device
    ky = (torch.arange(kh, device=dev) * dilation).repeat_interleave(kw)
    kx = (torch.arange(kw, device=dev) * dilation).repeat(kh)
    base_y = (torch.arange(Ho, device=dev) * stride - padding)[:, None] + ky[None, :]
    base_x = (torch.arange(Wo, device=dev) * stride - padding)[:, None] + kx[None, :]
    ys = base_y.view(1, Ho, 1, 1, K) + off[..., 0]
    xs = base_x.view(1, 1, Wo, 1, K) + off[..., 1]
    cols = torch.stack([_bilinear_taps(x[i].reshape(H * W, C), H, W, ys[i], xs[i])
                        for i in range(B)])                       # (B, Ho, Wo, dg, K, C)
    if mask is not None:
        cols = cols * mask.reshape(B, Ho, Wo, dg, K)[..., None]
    if dg == 1:
        cols = cols[:, :, :, 0]
    else:
        cpg = C // dg
        cols = torch.stack([cols[:, :, :, g, :, g * cpg:(g + 1) * cpg] for g in range(dg)],
                           dim=-2).reshape(B, Ho, Wo, K, C)
    out = torch.einsum("bhwkc,kco->bhwo", cols.float(), weight.reshape(K, C, O).float())
    return out.to(x.dtype)


def masked_conv2d(x: torch.Tensor, mask: torch.Tensor, weight: torch.Tensor,
                  bias: torch.Tensor, padding: int = 1) -> torch.Tensor:
    """Masked conv (mmdet masked_conv): the stride-1 conv plus bias where
    mask > 0, zero elsewhere. x (B, H, W, C) NHWC; mask (B, H, W) or (1, H,
    W); weight HWIO, square (as the reference's op is de facto)."""
    kh, kw = weight.shape[:2]
    if kh != kw:
        raise ValueError("masked_conv2d: the reference op is square-kernel only")
    out = F.conv2d(x.permute(0, 3, 1, 2), weight.permute(3, 2, 0, 1).to(x.dtype), None, 1,
                   padding).permute(0, 2, 3, 1)
    out = out + bias.reshape(1, 1, 1, -1).to(out.dtype)
    return torch.where((mask > 0)[..., None], out, 0.0).to(x.dtype)
