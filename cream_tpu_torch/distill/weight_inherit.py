"""Weight inheritance: a small CLIP student initialized from a larger teacher.

Counterpart of `cream_tpu/distill/weight_inherit.py` (TinyCLIP/src/
open_clip/weight_inherit.py:71-138) on state_dicts in open_clip's names:
  * depth, 'interval_front': student block i of a tower takes the
    teacher's block i * (teacher depth // student depth) of the same tower
    (`visual.transformer.resblocks.*` and `transformer.resblocks.*` apart)
  * width: every tensor front-sliced to the student's shape
  * `in_proj_weight` (3 * H * hd, W) and `in_proj_bias` sliced head-aware:
    viewed as (3, H, hd, ...), keeping the first student heads of each of
    q, k and v
"""
from __future__ import annotations

import re
from typing import Mapping

import torch

_BLOCK_RE = re.compile(r"resblocks\.(\d+)")


def _front_slice(t: torch.Tensor, shape: tuple) -> torch.Tensor:
    out = t[tuple(slice(0, s) for s in shape)]
    if tuple(out.shape) != shape:
        raise ValueError(f"cannot slice a teacher tensor of shape {tuple(t.shape)} "
                         f"to the student's {shape}")
    return out


def _slice_in_proj(t: torch.Tensor, shape: tuple, head_dim: int) -> torch.Tensor:
    s_heads = shape[0] // (3 * head_dim)
    v = t.reshape(3, t.shape[0] // (3 * head_dim), head_dim, *t.shape[1:])
    v = v[:, :s_heads]
    if len(shape) == 2:
        v = v[..., :shape[1]]
    return v.reshape(shape)


def _depths(keys) -> dict[str, int]:
    """Each tower prefix (the text before `resblocks.`) -> its depth."""
    out: dict[str, int] = {}
    for k in keys:
        m = _BLOCK_RE.search(k)
        if m:
            out[k[:m.start()]] = max(out.get(k[:m.start()], 0), int(m.group(1)) + 1)
    return out


def weight_inherit(student: Mapping[str, torch.Tensor], teacher: Mapping[str, torch.Tensor],
                   head_dim: int = 64) -> dict[str, torch.Tensor]:
    """`student`: the student's state_dict (only its shapes are read);
    `teacher`: the teacher's. Returns the student's state_dict inherited
    from the teacher (fp32 contiguous copies)."""
    s_depth, t_depth = _depths(student), _depths(teacher)

    def teacher_key(key: str) -> str:
        m = _BLOCK_RE.search(key)
        if not m:
            return key
        prefix = key[:m.start()]
        step = max(t_depth.get(prefix, 0) // max(s_depth[prefix], 1), 1)
        return f"{prefix}resblocks.{int(m.group(1)) * step}{key[m.end():]}"

    out = {}
    for key, s in student.items():
        shape = tuple(s.shape)
        t_key = teacher_key(key)
        if t_key not in teacher:
            raise KeyError(f"the teacher has no {t_key} for the student's {key}")
        t = torch.as_tensor(teacher[t_key])
        if key.endswith(("in_proj_weight", "in_proj_bias")):
            t = _slice_in_proj(t, shape, head_dim)
        else:
            t = _front_slice(t, shape)
        out[key] = t.detach().to("cpu", torch.float32).contiguous().clone()
    return out
