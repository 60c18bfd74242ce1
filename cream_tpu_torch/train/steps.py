"""Train and eval step factories.

Counterpart of `cream_tpu/train/steps.py` on one card: forward, loss,
backward, optimizer step and the step's metrics. Nothing is jitted: the
model runs eagerly, and on the card its window attention goes through the
K1/K2 kernels. Metrics stay on the device as 0-d tensors, so a step does not
wait for the card; read them with `float()` where the host needs them.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from cream_tpu_torch.train.optim import global_norm
from cream_tpu_torch.train.state import TrainState


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """labels: int class ids (B,) or soft targets (B, C)."""
    if labels.ndim == logits.ndim:
        return -(labels * F.log_softmax(logits, dim=-1)).sum(-1).mean()
    return F.cross_entropy(logits, labels.long())


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The step's generator on `device`, a pure function of (seed, step):
    the counterpart of `jax.random.fold_in(rng, step)`."""
    state = np.random.SeedSequence([seed, step]).generate_state(2, np.uint32)
    gen = torch.Generator(device)
    gen.manual_seed(int(state[0]) << 31 | int(state[1]) >> 1)
    return gen


def loss_and_grads(model: torch.nn.Module, batch, loss_fn: Callable,
                   generator: torch.Generator | None = None):
    """One forward and backward in train mode: (loss, logits, grads by
    param name). BatchNorm's running stats update as a side effect."""
    model.train()
    logits = model(batch["image"], generator)
    if isinstance(logits, tuple):
        raise TypeError(
            f"{type(model).__name__} returned a tuple in train mode (a distilled DeiT's "
            "(head, head_dist) pair, or Mini-Swin's distillation captures): this step "
            "takes logits; DeiT's hard or soft distillation needs a teacher "
            "(train.losses.deit_distillation_loss), which no train step wires yet")
    loss = loss_fn(logits, batch["label"])
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), logits.detach(), dict(zip(params, grads))


def supernet_grads(model: torch.nn.Module, loss: torch.Tensor) -> dict:
    """Grads of `loss` by param name for a supernet's step: the params off
    the sampled path get zero grads, as the JAX package's masked supernets
    give them (weight decay and momentum then move them as JAX's do). A
    fixed model's step takes `loss_and_grads`, where a param the loss does
    not reach raises."""
    params = dict(model.named_parameters())
    return dict(zip(params, torch.autograd.grad(loss, list(params.values()),
                                                materialize_grads=True)))


def make_train_step(loss_fn: Callable = cross_entropy_loss):
    """Returns train_step(state, batch, seed=0) -> (state, metrics).

    batch: {'image': (B, H, W, C) on the model's device, 'label': (B,) int
    ids or (B, num_classes) targets}. The state's model runs in train mode
    with the generator `step_generator(seed, state.step)` for drop path and
    dropout; BatchNorm running stats update in place. metrics: 'loss',
    'accuracy' (int labels only) and 'grad_norm', the global norm of the raw
    grads before any clipping."""

    def step(state: TrainState, batch, seed: int = 0):
        gen = step_generator(seed, state.step, batch["image"].device)
        loss, logits, grads = loss_and_grads(state.model, batch, loss_fn, gen)
        state.apply_gradients(grads)
        metrics = {"loss": loss}
        labels = batch["label"]
        if labels.ndim == 1:
            metrics["accuracy"] = (logits.argmax(-1) == labels).float().mean()
        metrics["grad_norm"] = global_norm(grads.values())
        return state, metrics

    return step


def make_eval_step():
    """Returns eval_step(state, batch) -> metrics, sum-reduced counts
    'correct1', 'correct5', 'n', 'loss_sum' of the state's model in eval
    mode over the examples with a label >= 0 (padding has label -1)."""

    @torch.no_grad()
    def step(state: TrainState, batch):
        state.model.eval()
        images, labels = batch["image"], batch["label"].long()
        logits = state.model(images).float()
        top1 = logits.argmax(-1) == labels
        k = min(5, logits.shape[-1])
        top5 = (logits.topk(k, dim=-1).indices == labels[:, None]).any(-1)
        valid = labels >= 0
        ce = F.cross_entropy(logits, labels.clamp(min=0), reduction="none")
        return {"correct1": (top1 & valid).sum(), "correct5": (top5 & valid).sum(),
                "n": valid.sum(), "loss_sum": torch.where(valid, ce, 0.0).sum()}

    return step


def make_loss_step(loss_fn: Callable):
    """Returns step(state, *args) -> (state, loss, metrics) for a model whose
    loss is not a function of logits and labels (the detectors'):
    loss_fn(model, *args) -> (loss, metrics) runs with the model in train
    mode; the grads of the loss by param name go to the state's optimizer.
    metrics gain 'grad_norm', the global norm of the raw grads; all stay on
    the device."""

    def step(state: TrainState, *args):
        model = state.model
        model.train()
        loss, metrics = loss_fn(model, *args)
        params = dict(model.named_parameters())
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        state.apply_gradients(grads)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return state, loss.detach(), {**metrics, "grad_norm": global_norm(grads.values())}

    return step
