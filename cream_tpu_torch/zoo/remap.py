"""ImageNet-22k -> 1k logits remap (TinyViT's RemapLayer).

Counterpart of `cream_tpu/zoo/remap.py` (TinyViT/models/remap_layer.py:
10-25): a 22k-class teacher's logits are gathered at the 1k classes' 22k
indices to give 1k logits (save_logits with a 22k teacher). The mapping
file (imagenet_1kto22k.txt: line i = the 22k index of 1k class i, -1 where
the class is absent) is user-supplied public data.
"""
from __future__ import annotations

import numpy as np
import torch


def load_1k_to_22k(path: str) -> np.ndarray:
    with open(path) as f:
        mapping = np.asarray([int(line) for line in f if line.strip()], np.int32)
    if mapping.shape != (1000,):
        raise ValueError(f"{path}: {mapping.shape[0]} entries, want 1000")
    return mapping


def remap_22k_to_1k(logits_22k: torch.Tensor, mapping) -> torch.Tensor:
    """(B, C22k) -> (B, len(mapping)); classes the mapping marks -1 get
    -inf, so their softmax probability is 0. `mapping`: a numpy array or a
    tensor (keep it on the logits' device to spare a copy a call)."""
    mapping = torch.as_tensor(mapping, device=logits_22k.device).long()
    out = logits_22k[:, mapping.clamp(min=0)]
    return out.masked_fill(mapping[None, :] < 0, float("-inf"))
