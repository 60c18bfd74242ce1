"""Window partition / reverse for local attention, NHWC layout.

Pad bottom/right to a window multiple with zeros, tile into (ws, ws) windows,
attend per window, reverse, crop the padding.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def window_partition(x: torch.Tensor, window: int
                     ) -> tuple[torch.Tensor, tuple[int, int]]:
    """(B, H, W, C) -> (B * nH * nW, window*window, C), plus the padded (pH, pW).

    Pads H/W up to multiples of `window` with zeros."""
    B, H, W, C = x.shape
    pad_b = (-H) % window
    pad_r = (-W) % window
    if pad_b or pad_r:
        x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
    pH, pW = H + pad_b, W + pad_r
    nH, nW = pH // window, pW // window
    x = x.reshape(B, nH, window, nW, window, C)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B * nH * nW, window * window, C)
    return x, (pH, pW)


def window_reverse(windows: torch.Tensor, window: int,
                   padded_hw: tuple[int, int], out_hw: tuple[int, int]
                   ) -> torch.Tensor:
    """Inverse of window_partition; crops back to out_hw. Returns (B, H, W, C)."""
    pH, pW = padded_hw
    H, W = out_hw
    nH, nW = pH // window, pW // window
    C = windows.shape[-1]
    B = windows.shape[0] // (nH * nW)
    x = windows.reshape(B, nH, nW, window, window, C)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, pH, pW, C)
    if pH != H or pW != W:
        x = x[:, :H, :W, :]
    return x
