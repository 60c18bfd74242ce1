"""AutoFormer supernet training engine.

Counterpart of `cream_tpu/nas/supernet_engine.py` (AutoFormer/
supernet_engine.py:26-112): every batch trains a different subnet, sampled
uniformly from the space, against CE (optionally plus a frozen teacher's
KD, :66-71). The supernet slices its weights per config, so the one model
object and its optimizer serve every config; the inactive rows and
columns of each weight get zero grads.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from cream_tpu_torch.models.autoformer import SearchSpace, sample_config
from cream_tpu_torch.train.losses import deit_distillation_loss
from cream_tpu_torch.train.optim import global_norm
from cream_tpu_torch.train.state import TrainState
from cream_tpu_torch.train.steps import step_generator, supernet_grads


def make_supernet_train_step(teacher: Callable | None = None, distill_kind: str = "none",
                             alpha: float = 0.5, tau: float = 1.0):
    """step(state, batch, config, seed=0) -> (state, metrics).

    batch: {'image': NHWC on the model's device, 'label': (B,) int ids}.
    The state's supernet runs `config` in train mode with drop path drawn
    from `step_generator(seed, state.step)`; the loss is the mean CE on
    fp32 logits, or with a `teacher` (images -> logits, run without grad)
    `deit_distillation_loss(ce, logits, teacher_logits, distill_kind,
    alpha, tau)`. metrics: 'loss', 'accuracy', 'grad_norm' (the raw
    grads')."""

    def step(state: TrainState, batch, config: dict, seed: int = 0):
        model = state.model
        model.train()
        gen = step_generator(seed, state.step, batch["image"].device)
        logits = model(batch["image"], gen, config=config).float()
        loss = F.cross_entropy(logits, batch["label"].long())
        if teacher is not None and distill_kind != "none":
            with torch.no_grad():
                t_logits = teacher(batch["image"]).float()
            loss = deit_distillation_loss(loss, logits, t_logits, kind=distill_kind,
                                          alpha=alpha, tau=tau)
        grads = supernet_grads(model, loss)
        state.apply_gradients(grads)
        acc = (logits.argmax(-1) == batch["label"]).float().mean()
        return state, {"loss": loss.detach(), "accuracy": acc,
                       "grad_norm": global_norm(grads.values())}

    return step


def train_supernet_epoch(state: TrainState, step_fn, batches, space: SearchSpace, epoch: int,
                         rng_seed: int = 0, log=print, log_every: int = 50):
    """One epoch of random-subnet training. The config RNG is
    default_rng(rng_seed + epoch) (supernet_engine.py:36), so a run draws
    the JAX engine's configs in its order. Returns (state, losses)."""
    cfg_rng = np.random.default_rng(rng_seed + epoch)
    losses = []
    for i, batch in enumerate(batches):
        state, metrics = step_fn(state, batch, sample_config(cfg_rng, space), rng_seed)
        losses.append(float(metrics["loss"]))
        if i % log_every == 0:
            log(f"supernet epoch {epoch} [{i}] loss={losses[-1]:.4f} "
                f"acc={float(metrics['accuracy']):.4f}")
    return state, losses
