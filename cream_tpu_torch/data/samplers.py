"""Repeated augmentation (DeiT's RASampler), as an epoch order.

Counterpart of `cream_tpu/data/samplers.py` (AutoFormer/lib/samplers.py):
each epoch draws ~len(dataset) indices where every chosen sample appears
`repetitions` times; the repeats differ because the loader folds the repeat
id into each sample's augmentation seed.
"""
from __future__ import annotations

import numpy as np


def repeated_aug_order(n: int, epoch: int, seed: int = 0,
                       repetitions: int = 3) -> tuple[np.ndarray, np.ndarray]:
    """Returns (indices, repeat_ids), each length ~n: n//reps distinct samples
    each repeated `repetitions` times, shuffled."""
    rng = np.random.default_rng(seed + epoch)
    chosen = rng.permutation(n)[: max(n // repetitions, 1)]
    idx = np.repeat(chosen, repetitions)
    rep = np.tile(np.arange(repetitions), len(chosen))
    order = rng.permutation(len(idx))
    return idx[order][:n], rep[order][:n]
