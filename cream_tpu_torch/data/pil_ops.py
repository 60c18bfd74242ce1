"""Pillow's image operations in numpy, bit for bit.

The JAX package's augmentation and eval preprocessing call Pillow
(`Image.resize` bicubic with a box, `Image.transform` affine bilinear,
`Image.rotate`, `ImageOps`, `ImageEnhance`, `Image.blend`). The port runs
where Pillow may be absent, so this module computes the same results on
uint8 HWC RGB arrays: every function returns what the Pillow call returns
for the same pixels and arguments, to the last level. The arithmetic
follows Pillow's C: the resampler's 22-bit fixed-point coefficients, the
geometric filters' float64 taps, `blend`'s float32 alpha.

The pixel work is vectorised over the image (a loop over output blocks at
most); a loader runs images in parallel on worker processes
(`data.imagenet.Workers`).
"""
from __future__ import annotations

import math

import numpy as np

_PRECISION_BITS = 32 - 8 - 2


def _bicubic(x: np.ndarray) -> np.ndarray:
    """Pillow's bicubic filter (a = -0.5), float64."""
    x = np.abs(x)
    near = ((1.5 * x - 2.5) * x) * x + 1
    far = ((((x - 5) * x + 8) * x) - 4) * -0.5
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _coeffs(in_size: int, in0: float, in1: float, out_size: int):
    """Pillow's `precompute_coeffs` + `normalize_coeffs_8bpc` for the bicubic
    filter along one axis: each output's first input index and tap count
    (out_size,) and its fixed-point weights (out_size, ksize) int32, zero
    past its taps. The box edges are C floats, as Pillow keeps them."""
    in0, in1 = np.float32(in0), np.float32(in1)
    scale = float(np.float32(in1 - in0)) / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = float(in0) + (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5), in_size).astype(np.int64) - xmin
    taps = np.arange(ksize)
    w = _bicubic(((xmin[:, None] + taps) - center[:, None] + 0.5) * (1.0 / filterscale))
    w = np.where(taps < xmax[:, None], w, 0.0)
    ww = np.zeros(out_size)
    for j in range(ksize):                  # Pillow's sequential sum
        ww = ww + w[:, j]
    w = w / np.where(ww != 0.0, ww, 1.0)[:, None]
    s = w * (1 << _PRECISION_BITS)
    k = np.trunc(np.where(w < 0, -0.5 + s, 0.5 + s)).astype(np.int32)
    return xmin, xmax, k


def _resample_rows(src: np.ndarray, xmin: np.ndarray, k: np.ndarray) -> np.ndarray:
    """One separable pass of Pillow's 8-bit resampler along the first axis of
    a 2-D uint8 array: for each output row, the int32 weighted sum of its
    taps (exact, as Pillow's int32 accumulator) plus the rounding constant,
    an arithmetic shift and the clip to 0..255. Outputs go in blocks of 16
    rows, so each block's gathered taps stay in cache."""
    src = src.astype(np.int32)
    idx = np.minimum(xmin[:, None] + np.arange(k.shape[1]), src.shape[0] - 1)
    acc = np.empty((len(xmin), src.shape[1]), np.int32)
    for o in range(0, len(xmin), 16):
        np.einsum("okw,ok->ow", src[idx[o:o + 16]], k[o:o + 16], out=acc[o:o + 16])
    acc += 1 << (_PRECISION_BITS - 1)
    np.right_shift(acc, _PRECISION_BITS, out=acc)
    return np.clip(acc, 0, 255).astype(np.uint8)


def resize_bicubic(img: np.ndarray, size: tuple[int, int], box=None) -> np.ndarray:
    """`Image.resize(size, BICUBIC, box=box)` of an RGB image: size (w, h),
    box (x0, y0, x1, y1) in source pixels (floats allowed), the whole image
    by default. The horizontal pass runs first, on the rows the vertical
    pass reads, each pass only where Pillow runs it."""
    H, W = img.shape[:2]
    w, h = int(size[0]), int(size[1])
    if box is None:
        box = (0, 0, W, H)
    box = tuple(box)
    if (W, H) == (w, h) and box == (0, 0, W, H):
        return img.copy()
    b = np.asarray(box, np.float32)
    if b[0] < 0 or b[1] < 0 or b[2] > W or b[3] > H or b[2] < b[0] or b[3] < b[1]:
        raise ValueError(f"box {box} is not inside the {W}x{H} image")
    if w <= 0 or h <= 0:
        raise ValueError(f"size {size} must be positive")
    need_h = w != W or b[0] != 0 or b[2] != w
    need_v = h != H or b[1] != 0 or b[3] != h
    xmin, _, kx = _coeffs(W, b[0], b[2], w)
    ymin, ymax, ky = _coeffs(H, b[1], b[3], h)
    out = img
    if need_h:
        first, last = int(ymin[0]), int(ymin[-1] + ymax[-1])
        rows = img[first:last]
        cols = rows.transpose(1, 0, 2).reshape(W, -1)
        out = _resample_rows(cols, xmin, kx).reshape(w, last - first, -1).transpose(1, 0, 2)
        ymin = ymin - first
    if need_v:
        out = _resample_rows(out.reshape(out.shape[0], -1), ymin, ky).reshape(h, w, -1)
    return np.ascontiguousarray(out)


def affine_bilinear(img: np.ndarray, matrix, fill=(0, 0, 0)) -> np.ndarray:
    """`Image.transform(img.size, AFFINE, matrix, resample=BILINEAR,
    fillcolor=fill)`: output pixel (x, y) samples the input at
    (a x' + b y' + c, d x' + e y' + f) with x' = x + 0.5, y' = y + 0.5;
    a point outside [0, W) x [0, H) takes the fill; inside, Pillow's float64
    bilinear taps at pixel centres, edge-clamped, truncated to uint8."""
    H, W = img.shape[:2]
    a, b, c, d, e, f = (float(v) for v in matrix[:6])
    xo = np.arange(W, dtype=np.float64) + 0.5
    yo = (np.arange(H, dtype=np.float64) + 0.5)[:, None]
    xin = a * xo + b * yo + c
    yin = d * xo + e * yo + f
    inside = ((xin >= 0.0) & (xin < W) & (yin >= 0.0) & (yin < H)).ravel()
    xin = xin.ravel()[inside] - 0.5
    yin = yin.ravel()[inside] - 0.5
    x = np.floor(xin)
    y = np.floor(yin)
    dx = xin - x
    dy = yin - y
    x = x.astype(np.intp)
    y = y.astype(np.intp)
    x0, x1 = np.clip(x, 0, W - 1), np.clip(x + 1, 0, W - 1)
    y0, y1 = np.clip(y, 0, H - 1) * W, np.clip(y + 1, 0, H - 1) * W
    # the four taps of every band at once, bands leading: (C, 4, n)
    planes = np.ascontiguousarray(img.reshape(H * W, -1).T)
    p = np.take(planes, np.stack([y0 + x0, y0 + x1, y1 + x0, y1 + x1]), axis=1)
    p = p.astype(np.float64)
    v1 = p[:, 1] - p[:, 0]
    v1 *= dx
    v1 += p[:, 0]               # v1 = p00 + (p01 - p00) dx
    v2 = p[:, 3] - p[:, 2]
    v2 *= dx
    v2 += p[:, 2]               # v2 = p10 + (p11 - p10) dx
    # a row past the last (y + 1 == H) clamps to row y: v2 == v1, and
    # Pillow's one-row result v1 is what the blend gives
    v2 -= v1
    v2 *= dy
    v2 += v1
    out = np.empty((H * W, img.shape[2]), np.uint8)
    out[:] = np.asarray(fill, np.uint8)
    out[inside] = v2.T.astype(np.uint8)
    return out.reshape(img.shape)


def rotate_bilinear(img: np.ndarray, degrees: float, fill=(0, 0, 0)) -> np.ndarray:
    """`Image.rotate(degrees, resample=BILINEAR, fillcolor=fill)`:
    counter-clockwise about the centre (w/2, h/2), the same size; Pillow's
    exact-angle fast paths, its matrix (cos and sin rounded to 15 places),
    then `affine_bilinear`."""
    angle = degrees % 360.0
    if angle == 0:
        return img.copy()
    if angle == 180:
        return np.ascontiguousarray(img[::-1, ::-1])
    H, W = img.shape[:2]
    if angle in (90, 270) and W == H:
        return np.ascontiguousarray(np.rot90(img, 1 if angle == 90 else -1))
    cx, cy = W / 2, H / 2
    angle = -math.radians(angle)
    m = [round(math.cos(angle), 15), round(math.sin(angle), 15), 0.0,
         round(-math.sin(angle), 15), round(math.cos(angle), 15), 0.0]
    m[2] = m[0] * -cx + m[1] * -cy + m[2] + cx
    m[5] = m[3] * -cx + m[4] * -cy + m[5] + cy
    return affine_bilinear(img, m, fill)


def flip_lr(img: np.ndarray) -> np.ndarray:
    """`Image.transpose(FLIP_LEFT_RIGHT)`."""
    return np.ascontiguousarray(img[:, ::-1])


def point(img: np.ndarray, lut) -> np.ndarray:
    """`Image.point(lut)` of an RGB image: a 256-entry table for every band
    or 768 entries, one table a band; entries clipped to 0..255."""
    lut = np.clip(np.asarray(lut, np.int64), 0, 255).astype(np.uint8)
    if lut.size == 256:
        return lut[img]
    lut = lut.reshape(3, 256)
    return np.stack([lut[c][img[..., c]] for c in range(3)], -1)


def _histograms(img: np.ndarray) -> list[np.ndarray]:
    return [np.bincount(img[..., c].ravel(), minlength=256) for c in range(img.shape[-1])]


def autocontrast(img: np.ndarray) -> np.ndarray:
    """`ImageOps.autocontrast(img)` (cutoff 0): each band stretched so its
    darkest level maps to 0 and its lightest to 255."""
    luts = []
    ix = np.arange(256)
    for h in _histograms(img):
        used = np.flatnonzero(h)
        lo, hi = (int(used[0]), int(used[-1])) if len(used) else (255, 0)
        if hi <= lo:
            luts.append(ix)
            continue
        scale = 255.0 / (hi - lo)
        offset = -lo * scale
        luts.append(np.clip(np.trunc(ix * scale + offset), 0, 255).astype(np.int64))
    return point(img, np.concatenate(luts))


def equalize(img: np.ndarray) -> np.ndarray:
    """`ImageOps.equalize(img)`: Pillow's integer cumulative-histogram table
    per band."""
    luts = []
    for h in _histograms(img):
        histo = h[h != 0]
        step = (int(histo.sum()) - int(histo[-1])) // 255 if len(histo) > 1 else 0
        if not step:
            luts.append(np.arange(256))
            continue
        n = step // 2 + np.concatenate([[0], np.cumsum(h)[:-1]])
        luts.append(n // step)
    return point(img, np.concatenate(luts))


def invert(img: np.ndarray) -> np.ndarray:
    """`ImageOps.invert(img)`."""
    return 255 - img


def solarize(img: np.ndarray, threshold: int = 128) -> np.ndarray:
    """`ImageOps.solarize(img, threshold)`: levels >= threshold inverted."""
    ix = np.arange(256)
    return point(img, np.where(ix < threshold, ix, 255 - ix))


def posterize(img: np.ndarray, bits: int) -> np.ndarray:
    """`ImageOps.posterize(img, bits)`: the low 8 - bits bits cleared."""
    return point(img, np.arange(256) & ~(2 ** (8 - bits) - 1))


def blend(im1: np.ndarray, im2: np.ndarray, alpha: float) -> np.ndarray:
    """`Image.blend(im1, im2, alpha)`: im1 + alpha (im2 - im1) in float32
    (Pillow takes alpha as a C float), clipped to 0..255 and truncated."""
    alpha = np.float32(alpha)
    if alpha == 0.0:
        return im1.copy()
    if alpha == 1.0:
        return im2.copy()
    a = im1.astype(np.float32)
    diff = (im2.astype(np.int16) - im1.astype(np.int16)).astype(np.float32)
    out = a + alpha * diff
    if not 0.0 <= alpha <= 1.0:
        np.clip(out, 0.0, 255.0, out=out)
    return out.astype(np.uint8)


def to_luma(img: np.ndarray) -> np.ndarray:
    """`convert("L")` of an RGB image: Pillow's fixed-point ITU-R 601-2
    luma, (19595 R + 38470 G + 7471 B + 0x8000) >> 16."""
    x = img.astype(np.int32)
    return ((x[..., 0] * 19595 + x[..., 1] * 38470 + x[..., 2] * 7471 + 0x8000)
            >> 16).astype(np.uint8)


def enhance_color(img: np.ndarray, factor: float) -> np.ndarray:
    """`ImageEnhance.Color(img).enhance(factor)`: blend from the luma image."""
    grey = np.repeat(to_luma(img)[..., None], 3, -1)
    return blend(grey, img, factor)


def enhance_contrast(img: np.ndarray, factor: float) -> np.ndarray:
    """`ImageEnhance.Contrast(img).enhance(factor)`: blend from a flat image
    of the luma's mean, rounded to an int."""
    luma = to_luma(img)
    mean = int(float(np.bincount(luma.ravel(), minlength=256) @ np.arange(256))
               / luma.size + 0.5) if luma.size else 0
    return blend(np.full_like(img, mean), img, factor)


def enhance_brightness(img: np.ndarray, factor: float) -> np.ndarray:
    """`ImageEnhance.Brightness(img).enhance(factor)`: blend from black."""
    return blend(np.zeros_like(img), img, factor)


def smooth(img: np.ndarray) -> np.ndarray:
    """`img.filter(ImageFilter.SMOOTH)`: the 3x3 kernel (1 1 1 / 1 5 1 /
    1 1 1) / 13 in float32, rows summed bottom, middle, top as Pillow's
    Filter.c does, rounded half up and clipped; the border pixels kept."""
    H, W = img.shape[:2]
    out = img.copy()
    if H < 3 or W < 3:
        return out
    k = np.float32(1) / np.float32(13), np.float32(5) / np.float32(13)
    x = img.astype(np.float32)

    def row(r, mid):
        return (x[r, :-2] * k[0] + x[r, 1:-1] * mid) + x[r, 2:] * k[0]

    ss = row(slice(2, None), k[0])
    ss = ss + row(slice(1, -1), k[1])
    ss = ss + row(slice(None, -2), k[0])
    out[1:-1, 1:-1] = np.clip(ss.astype(np.float64) + 0.5, 0, 255).astype(np.uint8)
    return out


def enhance_sharpness(img: np.ndarray, factor: float) -> np.ndarray:
    """`ImageEnhance.Sharpness(img).enhance(factor)`: blend from SMOOTH."""
    return blend(smooth(img), img, factor)


def convert_rgb(img: np.ndarray) -> np.ndarray:
    """`convert("RGB")` of a decoder's L (H, W) or (H, W, 1), LA, RGB or
    RGBA uint8 array: grey replicated, alpha dropped."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"expected a uint8 image, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    bands = img.shape[-1]
    if bands in (1, 2):
        return np.ascontiguousarray(np.repeat(img[..., :1], 3, -1))
    if bands in (3, 4):
        return np.ascontiguousarray(img[..., :3])
    raise ValueError(f"cannot convert a {bands}-band image to RGB")
