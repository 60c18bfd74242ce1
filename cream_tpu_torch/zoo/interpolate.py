"""Resolution-change checkpoint remapping (torch-bicubic parity).

Counterpart of `cream_tpu/zoo/interpolate.py`, on the port's flat
state_dicts (released parameter names) instead of nested variable trees.

The reference finetunes 224-pretrained models at 384/512 by bicubic-
interpolating the learned position tables when shapes mismatch on load
(TinyViT/utils.py:142-190, same machinery in MiniViT/Mini-Swin/utils.py and
the Swin lineage):

  - ``attention_biases``            (nH, L): viewed as (nH, S, S), S=sqrt(L)
  - ``relative_position_bias_table`` (L, nH): transposed to (nH, S, S)
  - ``absolute_pos_embed``        (1, L, C): viewed as (S, S, C)

All use ``F.interpolate(mode='bicubic')`` with align_corners=False. PyTorch's
bicubic kernel uses A=-0.75 (jax.image.resize and PIL use A=-0.5), so this
module implements the torch kernel exactly: half-pixel source mapping,
4-tap cubic convolution, taps clamped to the edge. Everything is host-side
numpy at load time.
"""
from __future__ import annotations

import numpy as np

# leaf names handled per the reference's load_pretrained
_REMAP_LEAVES = ("attention_biases", "relative_position_bias_table",
                 "absolute_pos_embed")


def _cubic_kernel(t: np.ndarray, A: float = -0.75) -> np.ndarray:
    """PyTorch's cubic convolution weights for |t| in [0, 2]
    (aten/src/ATen/native/UpSample.h cubic_convolution1/2)."""
    t = np.abs(t)
    w1 = ((A + 2) * t - (A + 3)) * t * t + 1          # |t| <= 1
    w2 = ((A * t - 5 * A) * t + 8 * A) * t - 4 * A    # 1 < |t| < 2
    return np.where(t <= 1, w1, np.where(t < 2, w2, 0.0))


def _resize_matrix(out_size: int, in_size: int) -> np.ndarray:
    """(out, in) matrix M with (M @ v) == torch bicubic resize of v
    (align_corners=False, no antialias; edge taps clamped)."""
    M = np.zeros((out_size, in_size), np.float64)
    if out_size == in_size:
        np.fill_diagonal(M, 1.0)
        return M
    scale = in_size / out_size
    dst = np.arange(out_size)
    src = (dst + 0.5) * scale - 0.5
    i0 = np.floor(src).astype(np.int64)
    t = src - i0
    for k in range(-1, 3):
        idx = np.clip(i0 + k, 0, in_size - 1)
        w = _cubic_kernel(t - k)
        np.add.at(M, (dst, idx), w)
    return M


def bicubic_resize_2d(x: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    """Resize the last two axes of x with torch-exact bicubic."""
    H, W = x.shape[-2:]
    Mh = _resize_matrix(out_hw[0], H)
    Mw = _resize_matrix(out_hw[1], W)
    y = np.einsum("oh,...hw,pw->...op", Mh, x.astype(np.float64), Mw)
    return y.astype(x.dtype)


def _sq(n: int, what: str) -> int:
    s = int(round(n ** 0.5))
    if s * s != n:
        raise ValueError(f"{what}: length {n} is not a square")
    return s


def remap_leaf(name: str, value: np.ndarray, target_shape: tuple[int, ...]
               ) -> np.ndarray:
    """Resize one position table to `target_shape` per reference semantics."""
    value = np.asarray(value)
    if name == "attention_biases":                      # (nH, L)
        nH, L1 = value.shape
        nH2, L2 = target_shape
        if nH != nH2:
            raise ValueError(f"attention_biases heads {nH} != {nH2}")
        S1, S2 = _sq(L1, name), _sq(L2, name)
        return bicubic_resize_2d(value.reshape(nH, S1, S1),
                                 (S2, S2)).reshape(nH, L2)
    if name == "relative_position_bias_table":          # (L, nH)
        L1, nH = value.shape
        L2, nH2 = target_shape
        if nH != nH2:
            raise ValueError(f"rel-pos-bias heads {nH} != {nH2}")
        S1, S2 = _sq(L1, name), _sq(L2, name)
        t = value.T.reshape(nH, S1, S1)
        return bicubic_resize_2d(t, (S2, S2)).reshape(nH, L2).T
    if name == "absolute_pos_embed":                    # (1, L, C)
        _, L1, C = value.shape
        _, L2, C2 = target_shape
        if C != C2:
            raise ValueError(f"absolute_pos_embed dim {C} != {C2}")
        S1, S2 = _sq(L1, name), _sq(L2, name)
        t = value.reshape(S1, S1, C).transpose(2, 0, 1)  # (C, S1, S1)
        t = bicubic_resize_2d(t, (S2, S2))
        return t.transpose(1, 2, 0).reshape(1, L2, C)
    raise ValueError(f"no remap rule for leaf {name!r}")


def remap_resolution(state_dict: dict, template: dict) -> dict:
    """Check `state_dict` against `template` ({name: shape}, e.g. a model's
    state_dict) and bicubic-resize every position table whose shape
    differs; a name absent from the template, or any other mismatch,
    raises. Returns a new dict; tables come back as float32 numpy arrays,
    other entries as they were."""
    missing = set(state_dict) - set(template)
    if missing:
        raise ValueError(f"keys {sorted(missing)} absent from the target model")
    out = {}
    for name, v in state_dict.items():
        tgt = tuple(template[name])
        if tuple(np.shape(v)) == tgt:
            out[name] = v
            continue
        leaf = name.rsplit(".", 1)[-1]
        if leaf not in _REMAP_LEAVES:
            raise ValueError(f"{name}: shape {tuple(np.shape(v))} != target {tgt} "
                             f"and no interpolation rule applies")
        out[name] = remap_leaf(leaf, np.asarray(v, np.float32), tgt)
    return out
