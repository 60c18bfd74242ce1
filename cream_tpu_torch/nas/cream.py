"""Cream's prioritized-path distillation: the board, meta matching and the
train step.

Counterpart of `cream_tpu/nas/cream.py` (Cream/lib/models/
PrioritizedBoard.py:13-130, MetaMatchingNetwork.py:14-130 and the train
loop of lib/core/train.py:28-80).

The meta step differentiates the validation loss after one simulated SGD
step on the meta-weighted KD loss,

    L_val(θ − lr · ∂(m · L_kd)/∂θ),   m = sigmoid(−meta_head(s_out − t_out)),

with respect to the meta head's params. The JAX package writes it as one
`jax.grad`; here it is `torch.func.functional_call` on the simulated
weights and `torch.autograd.grad`. ∂(m · L_kd)/∂θ is m · ∂L_kd/∂θ, and
∂L_kd/∂θ does not depend on the meta head, so the simulated weights are
linear in m and the exact meta-grad needs no second derivative of the
model: ∂L_kd/∂θ is taken once, without a graph, and the chain runs through
m alone. θ is what JAX's `model.apply(params, ...)` takes there: the params
and the BN running statistics (the model runs its BN in eval mode, and the
simulated step moves the statistics too).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from cream_tpu_torch.train.optim import global_norm
from cream_tpu_torch.train.state import TrainState
from cream_tpu_torch.train.steps import supernet_grads


def sample_architecture(rng: np.random.Generator, layers_per_stage, choice_num: int = 6,
                        prob=None) -> np.ndarray:
    """A random path, biased by the board's op probabilities when given
    (PrioritizedBoard.get_cand_with_prob :76-92); JAX's draws."""
    arch = []
    for n in layers_per_stage:
        arch.extend(rng.choice(choice_num, size=n, p=prob).tolist())
    return np.asarray(arch, np.int32)


@dataclasses.dataclass
class BoardEntry:
    prec1: float
    flops: float
    arch: np.ndarray
    inputs: Any          # the saved minibatch slice
    logits: Any          # the path's softmax outputs on that slice


class PrioritizedBoard:
    """The top-K path pool ordered by accuracy (PrioritizedBoard.py)."""

    def __init__(self, pool_size: int = 10, acc_gap: float = 5.0, meta_sta_epoch: int = 20,
                 choice_num: int = 6):
        self.pool_size = pool_size
        self.acc_gap = acc_gap
        self.meta_sta_epoch = meta_sta_epoch
        self.choice_num = choice_num
        self.board: list[BoardEntry] = []

    def __len__(self):
        return len(self.board)

    def is_update(self, epoch: int, prec1: float, flops: float) -> bool:
        if epoch <= self.meta_sta_epoch:
            return False
        if len(self.board) < self.pool_size:
            return True
        worst = self.board[-1]
        if prec1 > worst.prec1 + self.acc_gap:
            return True
        return prec1 > worst.prec1 and flops < worst.flops

    def update(self, epoch: int, prec1: float, flops: float, arch, inputs, logits) -> bool:
        if not self.is_update(epoch, prec1, flops):
            return False
        self.board.append(BoardEntry(float(prec1), float(flops), np.asarray(arch), inputs,
                                     logits))
        self.board.sort(key=lambda e: -e.prec1)
        del self.board[self.pool_size:]
        return True

    def op_probability(self) -> np.ndarray | None:
        """The 'teacher' path-sampling bias: op frequency over the board
        (PrioritizedBoard.py:56-72)."""
        if not self.board:
            return None
        counts = np.zeros(self.choice_num)
        for e in self.board:
            for op in np.asarray(e.arch).ravel():
                if op >= 0:
                    counts[op] += 1
        if counts.sum() == 0:
            return None
        return counts / counts.sum()

    @torch.no_grad()
    def select_teacher(self, apply_fn: Callable, meta_apply_fn: Callable | None, student_arch):
        """The meta pick (PrioritizedBoard.py:27-42): each entry's drift
        softmax(apply_fn(inputs, arch)) - its stored outputs, scored by the
        meta head; returns (sigmoid(-best score), the best entry's arch).
        Without a meta head: (0.5, the top entry's arch). (None, None) on an
        empty board."""
        if not self.board:
            return None, None
        if meta_apply_fn is None:
            return 0.5, self.board[0].arch
        best_w, best = -1e9, None
        for e in self.board:
            out = torch.softmax(apply_fn(e.inputs, e.arch).float(), -1)
            w = float(meta_apply_fn(out - e.logits))
            if w > best_w:
                best_w, best = w, e
        return float(torch.sigmoid(-torch.tensor(best_w))), best.arch


def soft_kd_loss(student_logits: torch.Tensor, teacher_probs: torch.Tensor) -> torch.Tensor:
    return -(teacher_probs * F.log_softmax(student_logits, -1)).sum(-1).mean()


def model_state(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """θ of the meta step: the params and the floating-point buffers (BN
    running statistics), by name: JAX's `variables`."""
    out = dict(model.named_parameters())
    out.update((n, b) for n, b in model.named_buffers() if b.is_floating_point())
    return out


def make_meta_update_step(model: torch.nn.Module, meta_head: torch.nn.Module,
                          sgd_lr: float = 0.1, slice_size: int = 8):
    """meta_step(x, y, student_arch, teacher_arch, kd_logits) -> (loss,
    grads of the meta head's params by name).

    x[:slice_size] is the KD slice, x and y [slice_size:2·slice_size] the
    validation slice; kd_logits are the softmax outputs the meta head's
    input is taken against (MetaMatchingNetwork.run_update :100-130; see
    the module's docstring). The model runs in eval mode; its state is not
    changed."""

    def meta_step(x, y, student_arch, teacher_arch, kd_logits):
        was_training = model.training
        model.eval()
        try:
            x_kd = x[:slice_size]
            x_val, y_val = x[slice_size:2 * slice_size], y[slice_size:2 * slice_size]
            theta = {n: t.detach() for n, t in model_state(model).items()}
            with torch.no_grad():
                t_probs = torch.softmax(model(x_kd, config=teacher_arch).float(), -1)
                s_out = torch.softmax(model(x_kd, config=student_arch).float(), -1)
            leaves = {n: t.detach().requires_grad_(True) for n, t in theta.items()}
            kd = soft_kd_loss(functional_call(model, leaves, (x_kd,),
                                              {"config": student_arch}).float(), t_probs)
            # off the student's path ∂L_kd/∂θ is 0: those weights do not move
            g = dict(zip(leaves, torch.autograd.grad(kd, list(leaves.values()),
                                                     allow_unused=True)))
            meta_params = dict(meta_head.named_parameters())
            meta_value = torch.sigmoid(-meta_head(s_out - kd_logits))
            simulated = {n: t if g[n] is None else t - sgd_lr * meta_value * g[n]
                         for n, t in theta.items()}
            v_logits = functional_call(model, simulated, (x_val,), {"config": student_arch})
            loss = F.cross_entropy(v_logits.float(), y_val.long())
            grads = torch.autograd.grad(loss, list(meta_params.values()))
        finally:
            model.train(was_training)
        return loss.detach(), dict(zip(meta_params, grads))

    return meta_step


def make_cream_train_step():
    """step(state, batch, student_arch, teacher_arch, meta_value, use_kd) ->
    (state, metrics): the student path in train mode (BN batch statistics,
    the chosen choices' running statistics updated); the loss is
    (meta_value·KD + (2 − meta_value)·CE) / 2 against the teacher path's
    softmax (Cream/lib/core/train.py:28-66), or CE alone while `use_kd` is
    off. The teacher path runs first, in eval mode and without grad, on the
    statistics from before the step, as JAX's does. metrics: 'loss',
    'accuracy', 'grad_norm'."""

    def step(state: TrainState, batch, student_arch, teacher_arch, meta_value: float,
             use_kd: bool):
        model = state.model
        images, labels = batch["image"], batch["label"].long()
        if use_kd:
            model.eval()
            with torch.no_grad():
                t_probs = torch.softmax(model(images, config=teacher_arch).float(), -1)
        model.train()
        logits = model(images, config=student_arch).float()
        loss = F.cross_entropy(logits, labels)
        if use_kd:
            loss = (meta_value * soft_kd_loss(logits, t_probs) + (2.0 - meta_value) * loss) / 2.0
        grads = supernet_grads(model, loss)
        state.apply_gradients(grads)
        acc = (logits.argmax(-1) == labels).float().mean()
        return state, {"loss": loss.detach(), "accuracy": acc,
                       "grad_norm": global_norm(grads.values())}

    return step
