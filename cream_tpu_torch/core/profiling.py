"""Profiling hooks: torch.profiler traces and a step timer.

Counterpart of `cream_tpu/core/profiling.py`: any section of a loop can be
captured as a Chrome trace (chrome://tracing or Perfetto), and a step timer
excludes its warmup steps.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch

from cream_tpu_torch.core.mesh import rank


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block (CPU activity, and CUDA's where a card is present)
    and write its Chrome trace to `log_dir/trace-rank<r>.json`; yields the
    profiler."""
    from torch.profiler import ProfilerActivity

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace-rank{rank()}.json"))


class StepTimer:
    """Wall-clock step timer with warmup exclusion: `with timer:` around a
    step; the first `warmup` steps are not kept. On a CUDA device the clock
    is read after the device's queued work is done, so a step's time is its
    device work's, not the time to enqueue it."""

    def __init__(self, warmup: int = 2, device=None):
        self.warmup = warmup
        self.device = None if device is None else torch.device(device)
        self.times: list[float] = []
        self._count = 0
        self._t = None

    def _clock(self) -> float:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def __enter__(self):
        self._t = self._clock()
        return self

    def __exit__(self, *exc):
        dt = self._clock() - self._t
        self._count += 1
        if self._count > self.warmup:
            self.times.append(dt)

    @property
    def mean(self) -> float:
        return sum(self.times) / max(len(self.times), 1)
