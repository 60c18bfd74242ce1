"""Optimizers + LR schedules with optax's semantics.

Counterpart of `cream_tpu/train/optim.py`. An optimizer here works on named
tensors ({name: tensor}, the names of `model.named_parameters()`) and
updates them in place, where optax returns new pytrees:

  * `make_adamw`: `optax.adamw` (eps outside the sqrt, decoupled decay
    `p -= lr*(u + wd*p)` on the params the mask selects), after an optional
    `clip_by_global_norm` and before optional layer-LR scales;
  * `make_sgd`: clip, masked decay added to the grads, `optax.sgd` momentum;
  * `MultiSteps`: `optax.MultiSteps` gradient accumulation;
  * schedules are read at the update count *before* the update, as optax
    reads them, so the first step uses the schedule's value at 0.

Updates run as multi-tensor (`torch._foreach_*`) ops, a few launches per
step for all params rather than a few per param: on the card a per-param
loop made most of a TinyViT-21M train step's launches and left the device
idle while the host issued them.
"""
from __future__ import annotations

import math
import re
from typing import Callable, Mapping

import torch
import torch.distributed as dist

from cream_tpu_torch.core.tensor_parallel import split_group

NO_DECAY_PATTERNS = (r"\bbias\b", r"\bscale\b", r"attention_biases",
                     r"\bnorm", r"\bbn\b", r"logit_scale",
                     r"pos_embed", r"cls_token", r"rel_pos")

Schedule = Callable[[int], float]


def weight_decay_mask(params: Mapping[str, torch.Tensor]) -> dict[str, bool]:
    """True where weight decay applies: 2D+ weights whose name matches none
    of `NO_DECAY_PATTERNS` (norms, biases, bias tables)."""
    return {name: p.ndim >= 2 and not any(re.search(pat, name)
                                          for pat in NO_DECAY_PATTERNS)
            for name, p in params.items()}


def layer_lr_scales(params: Mapping[str, torch.Tensor], depth: int,
                    block_of: Callable[[str], int | None],
                    decay_rate: float) -> dict[str, float]:
    """Per-param LR scale decay_rate ** (depth - 1 - block_of(name));
    `block_of` returning None (head params) counts as the last block."""
    def scale(name):
        b = block_of(name)
        return decay_rate ** (depth - 1 - (depth - 1 if b is None else b))
    return {name: scale(name) for name in params}


def global_norm(tensors, groups=None) -> torch.Tensor:
    """sqrt of the sum of squares of every element, as a 0-d fp32 tensor
    (the norm of the per-tensor norms). `groups`, one a tensor, names the
    model group (`core.tensor_parallel.split_group`) whose shards a tensor
    is one of, or None for a whole tensor: the shards' squares are summed
    over that group, the whole tensors' counted once, so every model rank
    gets the unsplit norm."""
    tensors = list(tensors)
    norms = torch._foreach_norm([t.float() for t in tensors])
    groups = list(groups or [None] * len(tensors))
    spans = {g for g in groups if g is not None}
    if not spans:
        return torch.linalg.vector_norm(torch.stack(norms))
    if len(spans) > 1:
        raise ValueError("global_norm: shards of more than one model group")
    squares = torch.stack(norms) ** 2
    mask = torch.tensor([g is not None for g in groups], dtype=squares.dtype,
                        device=squares.device)
    own = (squares * mask).sum()
    dist.all_reduce(own, group=spans.pop())
    return torch.sqrt(own + (squares * (1 - mask)).sum())


def split_groups(params: Mapping[str, torch.Tensor]) -> dict[str, object]:
    """{name: model group} of the params that hold a model rank's shard
    with collectives (`core.tensor_parallel.mark_split`)."""
    return {n: split_group(p) for n, p in params.items() if split_group(p) is not None}


def clip_by_global_norm(grads: Mapping[str, torch.Tensor], max_norm: float,
                        groups: Mapping[str, object] | None = None
                        ) -> dict[str, torch.Tensor]:
    """`optax.clip_by_global_norm`: g unchanged when ||g|| < max_norm, else
    g scaled to the norm max_norm, g / (||g|| / max_norm). (No +1e-6,
    unlike `clip_grad_norm_`.) Decided on the device, without a sync. The
    grads named in `groups` are model shards (`global_norm`)."""
    norm = global_norm(grads.values(), [(groups or {}).get(n) for n in grads])
    denom = torch.where(norm < max_norm, torch.ones_like(norm), norm / max_norm)
    return dict(zip(grads, torch._foreach_div(list(grads.values()), denom)))


def _as_schedule(lr: float | Schedule) -> Schedule:
    return lr if callable(lr) else (lambda count: lr)


class _Optimizer:
    """Shared by AdamW and SGD: clipping, the decay mask, layer scales, the
    update count and the schedule. Subclasses give the update direction of
    all params at once (`_directions`)."""

    def __init__(self, learning_rate, weight_decay: float,
                 clip_grad: float | None, mask: Mapping[str, bool] | None,
                 layer_scales: Mapping[str, float] | None):
        self.schedule = _as_schedule(learning_rate)
        self.weight_decay = weight_decay
        self.clip_grad = clip_grad
        self.mask = None if mask is None else dict(mask)
        self.layer_scales = None if layer_scales is None else dict(layer_scales)
        self.count = 0
        self.slots: dict[str, dict[str, torch.Tensor]] = {}

    def lr(self) -> float:
        """The learning rate the next update uses."""
        return float(self.schedule(self.count))

    @torch.no_grad()
    def step(self, params: Mapping[str, torch.Tensor],
             grads: Mapping[str, torch.Tensor]) -> None:
        """Update `params` in place from `grads` (same names). A split
        model's shards (`core.tensor_parallel.split_group`) enter the
        clipping norm once each, summed over their model group."""
        if self.clip_grad:
            grads = clip_by_global_norm(grads, self.clip_grad, split_groups(params))
        lr = self.lr()
        self.count += 1
        names = list(params)
        ps = [params[n] for n in names]
        u = self._directions(names, ps, [grads[n] for n in names])
        if self.layer_scales is not None:
            torch._foreach_mul_(u, [self.layer_scales[n] for n in names])
        torch._foreach_add_(ps, u, alpha=-lr)

    def _decay(self, names, ps, u) -> None:
        """u += weight_decay * p where the mask allows."""
        if not self.weight_decay:
            return
        idx = [i for i, n in enumerate(names) if self.mask is None or self.mask[n]]
        if idx:
            torch._foreach_add_([u[i] for i in idx], [ps[i] for i in idx],
                                alpha=self.weight_decay)

    def _slots(self, key: str, names, ps) -> list[torch.Tensor]:
        out = []
        for n, p in zip(names, ps):
            slots = self.slots.setdefault(n, {})
            if key not in slots:
                slots[key] = torch.zeros_like(p)
            out.append(slots[key])
        return out

    def state_dict(self) -> dict:
        return {"count": self.count, "slots": self.slots}

    def load_state_dict(self, sd: dict) -> None:
        self.count = int(sd["count"])
        self.slots = {n: {k: t.clone() for k, t in s.items()}
                      for n, s in sd["slots"].items()}

    def to(self, device) -> "_Optimizer":
        self.slots = {n: {k: t.to(device) for k, t in s.items()}
                      for n, s in self.slots.items()}
        return self


class AdamW(_Optimizer):
    """`optax.adamw`: u = m_hat / (sqrt(v_hat) + eps) (+ wd*p where the mask
    allows), p -= lr*u."""

    def __init__(self, learning_rate, weight_decay: float = 0.05,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 clip_grad: float | None = None, mask=None, layer_scales=None):
        super().__init__(learning_rate, weight_decay, clip_grad, mask,
                         layer_scales)
        self.b1, self.b2, self.eps = b1, b2, eps

    def _directions(self, names, ps, gs):
        mu, nu = self._slots("mu", names, ps), self._slots("nu", names, ps)
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, gs, alpha=1 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, gs, gs, value=1 - self.b2)
        den = torch._foreach_div(nu, 1 - self.b2 ** self.count)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        u = torch._foreach_div(mu, 1 - self.b1 ** self.count)
        torch._foreach_div_(u, den)
        self._decay(names, ps, u)
        return u


class SGD(_Optimizer):
    """`optax.sgd` with momentum (trace) after masked decay added to g."""

    def __init__(self, learning_rate, momentum: float = 0.9,
                 weight_decay: float = 0.0, nesterov: bool = False,
                 clip_grad: float | None = None, mask=None):
        super().__init__(learning_rate, weight_decay, clip_grad, mask, None)
        self.momentum, self.nesterov = momentum, nesterov

    def _directions(self, names, ps, gs):
        g = [t.clone() for t in gs]
        self._decay(names, ps, g)
        if not self.momentum:
            return g
        trace = self._slots("trace", names, ps)
        torch._foreach_mul_(trace, self.momentum)
        torch._foreach_add_(trace, g)
        if self.nesterov:
            return torch._foreach_add(g, trace, alpha=self.momentum)
        return [t.clone() for t in trace]


class MultiSteps:
    """`optax.MultiSteps`: average the grads of `every_k` calls (running
    mean), apply the inner optimizer on the k-th, leave params as they are
    on the others."""

    def __init__(self, inner: _Optimizer, every_k: int):
        self.inner, self.every_k = inner, every_k
        self.mini_step = 0
        self.acc: dict[str, torch.Tensor] = {}

    def lr(self) -> float:
        return self.inner.lr()

    @torch.no_grad()
    def step(self, params, grads) -> None:
        n = self.mini_step
        for name, g in grads.items():
            acc = self.acc.get(name)
            self.acc[name] = g.clone() if acc is None or n == 0 else acc + (g - acc) / (n + 1)
        self.mini_step += 1
        if self.mini_step == self.every_k:
            self.inner.step(params, self.acc)
            self.mini_step = 0

    def state_dict(self) -> dict:
        return {"mini_step": self.mini_step, "acc": self.acc,
                "inner": self.inner.state_dict()}

    def load_state_dict(self, sd: dict) -> None:
        self.mini_step = int(sd["mini_step"])
        self.acc = {k: t.clone() for k, t in sd["acc"].items()}
        self.inner.load_state_dict(sd["inner"])

    def to(self, device) -> "MultiSteps":
        self.acc = {k: t.to(device) for k, t in self.acc.items()}
        self.inner.to(device)
        return self


def make_adamw(learning_rate, weight_decay: float = 0.05,
               b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
               clip_grad: float | None = 5.0, params=None,
               layer_scales=None) -> AdamW:
    """AdamW with decay masking (from `params`' names; every param decays
    when `params` is None), optional clipping and layer-LR scaling.
    `learning_rate` may be a float or a schedule."""
    mask = weight_decay_mask(params) if params is not None else None
    return AdamW(learning_rate, weight_decay, b1, b2, eps, clip_grad, mask,
                 layer_scales)


def make_sgd(learning_rate, momentum: float = 0.9, weight_decay: float = 0.0,
             nesterov: bool = False, clip_grad: float | None = None,
             params=None) -> SGD:
    mask = weight_decay_mask(params) if params is not None else None
    return SGD(learning_rate, momentum, weight_decay, nesterov, clip_grad, mask)


def cosine_schedule(base_lr: float, warmup_steps: int, total_steps: int,
                    warmup_init_lr: float = 1e-7, min_lr: float = 1e-6
                    ) -> Schedule:
    """Linear warmup from `warmup_init_lr` to `base_lr` over `warmup_steps`,
    then cosine decay to `min_lr` over the remaining `total_steps -
    warmup_steps` (`optax.warmup_cosine_decay_schedule`)."""
    decay_steps = total_steps - warmup_steps
    if decay_steps <= 0:
        raise ValueError(f"cosine schedule needs total_steps > warmup_steps, "
                         f"got {total_steps} and {warmup_steps}")
    alpha = 0.0 if base_lr == 0.0 else min_lr / base_lr

    def sched(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - count / warmup_steps
            return (warmup_init_lr - base_lr) * frac + base_lr
        c = min(count - warmup_steps, decay_steps)
        cos = 0.5 * (1.0 + math.cos(math.pi * c / decay_steps))
        return base_lr * ((1.0 - alpha) * cos + alpha)
    return sched


def step_schedule(base_lr: float, step_size: int, gamma: float = 0.1,
                  warmup_steps: int = 0, warmup_init_lr: float = 1e-7
                  ) -> Schedule:
    """StepLR after a linear warmup (TinyCLIP's prune phase)."""
    def sched(count: int) -> float:
        if count < warmup_steps:
            return warmup_init_lr + (base_lr - warmup_init_lr) * (
                count / max(warmup_steps, 1))
        return base_lr * gamma ** ((count - warmup_steps) // step_size)
    return sched
