"""Named, seeded random streams.

Counterpart of `cream_tpu/core/prng.py`: `RngStream(seed).key(name, *indices)`
gives a `torch.Generator` that is a pure function of (seed, name, indices),
the same on every rank and in every run, where the JAX package folds
`_stable_hash(name)` and the indices into a `jax.random` key. The bits
differ from JAX's (no torch generator reproduces threefry); the names and
the hash are JAX's, so a stream keyed by name there is keyed by the same
name here.
"""
from __future__ import annotations

import numpy as np
import torch


def seeded_generator(words, device="cpu") -> torch.Generator:
    """A generator on `device` seeded from the integer words `words`
    through numpy's SeedSequence (63 bits of its state)."""
    state = np.random.SeedSequence([int(w) for w in words]).generate_state(2, np.uint32)
    gen = torch.Generator(device)
    gen.manual_seed(int(state[0]) << 31 | int(state[1]) >> 1)
    return gen


class RngStream:
    """stream = RngStream(seed)
    gen = stream.key("dropout", step)      # deterministic in (name, step)
    """

    def __init__(self, seed: int):
        self.seed = seed

    def key(self, name: str, *indices: int, device="cpu") -> torch.Generator:
        # the count of indices first: SeedSequence ignores trailing zero words,
        # and key(n) must differ from key(n, 0) as JAX's do
        return seeded_generator([self.seed, _stable_hash(name), len(indices), *indices],
                                device)


def _stable_hash(s: str) -> int:
    # Python's hash() is salted per process; FNV-1a is stable (JAX's, bit for bit)
    h = 2166136261
    for b in s.encode():
        h = ((h ^ b) * 16777619) & 0xFFFFFFFF
    return h
