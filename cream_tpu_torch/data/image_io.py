"""Image decoding to uint8 RGB arrays, without Pillow for BMP.

`read_rgb` decodes the uncompressed 24- and 32-bit BMPs that Pillow writes
(BITMAPINFOHEADER or a later header, bottom-up or top-down rows, BGR or
BGRX pixels) in numpy, giving what `Image.open(f).convert("RGB")` gives.
Every other format (JPEG, PNG, WebP, palette or compressed BMP) goes
through Pillow, imported when such a file is read; where Pillow is not
installed that raises an error naming the file.
"""
from __future__ import annotations

import io
import os
import struct

import numpy as np

from cream_tpu_torch.data.pil_ops import convert_rgb


def _source_name(src) -> str:
    return src if isinstance(src, (str, os.PathLike)) else "<bytes>"


def decode_bmp(data: bytes) -> np.ndarray | None:
    """An uncompressed 24/32-bit BMP's pixels as uint8 (H, W, 3) RGB, or
    None when the bytes are another BMP kind (or not a BMP)."""
    if len(data) < 30 or data[:2] != b"BM":
        return None
    offset, header = struct.unpack_from("<II", data, 10)
    if header < 40 or len(data) < 14 + header:
        return None
    width, height, planes, bits, compression = struct.unpack_from("<iiHHI", data, 18)
    if bits not in (24, 32) or compression != 0 or width <= 0 or height == 0:
        return None
    rows = abs(height)
    bpp = bits // 8
    stride = (width * bpp + 3) & ~3
    if offset + stride * rows > len(data):
        return None
    pix = np.frombuffer(data, np.uint8, stride * rows, offset).reshape(rows, stride)
    pix = pix[:, :width * bpp].reshape(rows, width, bpp)[..., 2::-1]
    if height > 0:                         # bottom-up rows
        pix = pix[::-1]
    return np.ascontiguousarray(pix)


def read_rgb(src) -> np.ndarray:
    """A path or the bytes of an image file -> uint8 (H, W, 3) RGB."""
    if isinstance(src, (bytes, bytearray, memoryview)):
        data = bytes(src)
    else:
        with open(src, "rb") as fh:
            data = fh.read()
    arr = decode_bmp(data)
    if arr is not None:
        return arr
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(
            f"{_source_name(src)}: only uncompressed 24/32-bit BMP is decoded "
            f"without Pillow; install Pillow to read this image") from e
    with Image.open(io.BytesIO(data)) as im:
        if im.mode in ("L", "LA", "RGB", "RGBA"):
            return convert_rgb(np.asarray(im))
        return np.asarray(im.convert("RGB"))


def write_bmp(path, img: np.ndarray) -> None:
    """Write a uint8 (H, W, 3) RGB array as a 24-bit bottom-up BMP, the
    layout Pillow writes."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    stride = (w * 3 + 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w * 3] = img[::-1, :, ::-1].reshape(h, w * 3)
    header = (b"BM" + struct.pack("<IHHI", 54 + rows.size, 0, 0, 54)
              + struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, rows.size, 0, 0, 0, 0))
    with open(path, "wb") as fh:
        fh.write(header)
        fh.write(rows.tobytes())
