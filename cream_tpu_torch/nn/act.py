"""Activation helpers.

gelu(): dtype-aware GELU, as in the JAX package. float32 keeps the exact erf
form; bfloat16/float16 use the tanh approximation, whose difference from erf
(<0.3% relative) is below those types' rounding resolution.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def gelu(x: torch.Tensor) -> torch.Tensor:
    approx = x.dtype in (torch.bfloat16, torch.float16)
    return F.gelu(x, approximate="tanh" if approx else "none")
