"""Host-side metric aggregation.

Counterpart of `cream_tpu/train/metrics.py`. Device metrics come out of the
steps already reduced over the batch; these meters smooth and aggregate them
over steps. `ScalarLogger`'s backends (tensorboard, wandb) are imported only
when asked for.
"""
from __future__ import annotations

import collections
import json
import os
import warnings

import torch

from cream_tpu_torch.core.mesh import all_reduce_sum


class AverageMeter:
    def __init__(self, window: int | None = None):
        self.window = window
        self.reset()

    def reset(self):
        self.sum = 0.0
        self.count = 0
        self._deque = collections.deque(maxlen=self.window)

    def update(self, value: float, n: int = 1):
        value = float(value)
        self.sum += value * n
        self.count += n
        self._deque.append(value)

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)

    @property
    def smoothed(self) -> float:
        return sum(self._deque) / max(len(self._deque), 1)


class MetricLogger:
    def __init__(self, delimiter: str = "  ", window: int = 20):
        self.meters: dict[str, AverageMeter] = collections.defaultdict(
            lambda: AverageMeter(window))
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __str__(self):
        return self.delimiter.join(
            f"{k}: {m.smoothed:.4f} ({m.avg:.4f})" for k, m in self.meters.items())


def global_counts(metrics_list: list[dict], device) -> dict:
    """The eval steps' counts ('correct1', 'correct5', 'n', 'loss_sum')
    summed over the batches and, under a data-parallel group, over the ranks
    (in float64 on `device`, where the group's backend takes them): the
    counts, not means, so that each rank's padded last batch weighs what it
    holds."""
    keys = ("correct1", "correct5", "n", "loss_sum")
    tot = torch.zeros(len(keys), dtype=torch.float64, device=device)
    for m in metrics_list:
        tot += torch.stack([torch.as_tensor(m[k], device=device).double() for k in keys])
    return dict(zip(keys, all_reduce_sum(tot).tolist()))


def topk_accuracy_counts(metrics_list: list[dict]) -> dict:
    """Aggregate eval-step count dicts into top-1/top-5 percentages."""
    tot = {k: 0.0 for k in ("correct1", "correct5", "n", "loss_sum")}
    for m in metrics_list:
        for k in tot:
            tot[k] += float(m[k])
    n = max(tot["n"], 1.0)
    return {"acc1": 100.0 * tot["correct1"] / n,
            "acc5": 100.0 * tot["correct5"] / n,
            "loss": tot["loss_sum"] / n, "n": int(tot["n"])}


class ScalarLogger:
    """Scalars to tensorboard (torch's SummaryWriter) / wandb / a JSONL file.
    Every backend is optional; without the wandb package the scalars go to
    a JSONL file instead, with a warning."""

    def __init__(self, logdir: str | None = None, tensorboard: bool = False,
                 wandb_project: str | None = None, wandb_config=None,
                 jsonl: str | None = None):
        self._tb = None
        self._wandb = None
        self._jsonl = None
        if tensorboard and logdir:
            from torch.utils.tensorboard import SummaryWriter
            self._tb = SummaryWriter(logdir)
        if wandb_project:
            try:
                import wandb
            except ImportError:
                warnings.warn("wandb not installed; logging scalars to "
                              "JSONL instead")
                jsonl = jsonl or (f"{logdir}/wandb_fallback.jsonl"
                                  if logdir else "scalars.jsonl")
            else:
                wandb.init(project=wandb_project, config=wandb_config, dir=logdir)
                self._wandb = wandb
        if jsonl:
            os.makedirs(os.path.dirname(jsonl) or ".", exist_ok=True)
            self._jsonl = open(jsonl, "a")

    def log(self, step: int, **scalars):
        scalars = {k: float(v) for k, v in scalars.items()}
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, v, step)
        if self._wandb is not None:
            self._wandb.log(scalars, step=step)
        if self._jsonl is not None:
            self._jsonl.write(json.dumps({"step": step, **scalars}) + "\n")
            self._jsonl.flush()

    def close(self):
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()
        if self._jsonl is not None:
            self._jsonl.close()
