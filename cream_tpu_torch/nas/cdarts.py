"""CDARTS: the cyclic differentiable architecture search loop.

Counterpart of `cream_tpu/nas/cdarts.py` (CDARTS/CDARTS/search.py and
lib/core/search_function.py:6-143): alternating
  weight steps: CE on the search network's weights (a train batch, BN in
                train mode);
  alpha steps:  on a val batch, with BN on its running statistics, CE
                through the search network plus the interactive loss (the
                T²-scaled KL) pulling its logits toward the discretized eval
                network's, plus an L1 on the softmax weight of the
                parameter-free ops (max pool, avg pool, skip).

The steps update the model's params and the alphas in place; the alphas are
a dict of fp32 tensors the searcher owns, stepped by their own Adam (betas
0.5, 0.999). Both DARTS' `SearchCNN` and NAS-Bench-201's `TinyNetwork201`
take `forward(x, alphas_normal, alphas_reduce)`, so one searcher drives
either.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from cream_tpu_torch.models.darts import PRIMITIVES, parse_genotype, wide
from cream_tpu_torch.train.losses import interactive_loss
from cream_tpu_torch.train.optim import global_norm, make_adamw, make_sgd

PARAM_FREE = ("max_pool_3x3", "avg_pool_3x3", "skip_connect")


def alpha_l1_regularization(alphas: dict, weight: float = 1e-3) -> torch.Tensor:
    """weight · the summed softmax weight of the parameter-free ops over
    every alpha set. The columns are DARTS' (`PRIMITIVES`), on NAS-Bench-201's
    alphas too, as in the JAX package (ROADMAP Queue 3)."""
    idxs = [PRIMITIVES.index(p) for p in PARAM_FREE]
    total = 0.0
    for a in alphas.values():
        w = torch.softmax(wide(a), -1)
        total = total + sum(w[:, i].sum() for i in idxs)
    return weight * total


def make_alpha_adam(lr: float = 3e-4):
    """The alphas' optimizer: `optax.adam(lr, b1=0.5, b2=0.999)`."""
    return make_adamw(lr, weight_decay=0.0, b1=0.5, b2=0.999, clip_grad=None)


def _ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return F.cross_entropy(wide(logits), labels.long())


def make_weight_step(model: torch.nn.Module, opt):
    """step(alphas, batch) -> metrics: one CE step of the search network's
    weights in train mode at fixed alphas (BN running statistics updated).
    metrics: 'loss', 'grad_norm' (0-d tensors on the device)."""

    def step(alphas: dict, batch) -> dict:
        model.train()
        logits = model(batch["image"], alphas["normal"], alphas["reduce"])
        loss = _ce(logits, batch["label"])
        params = dict(model.named_parameters())
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        opt.step(params, grads)
        return {"loss": loss.detach(), "grad_norm": global_norm(grads.values())}

    return step


def make_alpha_step(model: torch.nn.Module, alpha_opt, interactive_weight: float = 1.0,
                    tau: float = 2.0, l1_weight: float = 1e-3):
    """step(alphas, batch, eval_logits=None) -> metrics: one step of the
    alphas (in place) on a val batch, the search network in eval mode; the
    loss adds `interactive_weight` · the KL toward `eval_logits` where they
    are given, and the L1 on the parameter-free ops. metrics: 'loss',
    'grad_norm' (of the alpha grads)."""

    def step(alphas: dict, batch, eval_logits=None) -> dict:
        model.eval()
        leaves = {k: v.detach().requires_grad_(True) for k, v in alphas.items()}
        logits = model(batch["image"], leaves["normal"], leaves["reduce"])
        loss = _ce(logits, batch["label"])
        if eval_logits is not None:
            loss = loss + interactive_weight * interactive_loss(wide(logits),
                                                                wide(eval_logits), "kl", tau)
        loss = loss + alpha_l1_regularization(leaves, l1_weight)
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        alpha_opt.step(alphas, grads)
        return {"loss": loss.detach(), "grad_norm": global_norm(grads.values())}

    return step


class CyclicSearcher:
    """The CDARTS loop on the host (CDARTS/search.py): alternate weight
    steps and alpha steps (with the eval network's logits where given),
    then discretize. Defaults: SGD 0.05 / momentum 0.9 on the weights,
    Adam 3e-4 (b1 0.5) on the alphas."""

    def __init__(self, search_model: torch.nn.Module, alphas: dict, weight_opt=None,
                 alpha_opt=None):
        self.model = search_model
        self.alphas = alphas
        self.weight_opt = weight_opt or make_sgd(0.05, momentum=0.9)
        self.alpha_opt = alpha_opt or make_alpha_adam()
        self._wstep = make_weight_step(search_model, self.weight_opt)
        self._astep = make_alpha_step(search_model, self.alpha_opt)
        self.history: list = []

    def weight_step(self, batch) -> float:
        return float(self._wstep(self.alphas, batch)["loss"])

    def alpha_step(self, val_batch, eval_logits=None) -> float:
        return float(self._astep(self.alphas, val_batch, eval_logits)["loss"])

    def genotype(self):
        """The current discretization: `parse_genotype` of a DARTS search
        network's alphas, `parse_structure` of a NAS-Bench-201 one's (the
        JAX package's searcher calls `parse_genotype` on both, which
        refuses 201's 6 edges: ROADMAP Queue 3)."""
        from cream_tpu_torch.models.nasbench201 import TinyNetwork201, parse_structure
        if isinstance(self.model, TinyNetwork201):
            return parse_structure(self.alphas)
        return parse_genotype(self.alphas)

    def search_epoch(self, train_batches, val_batches, eval_logits_fn=None):
        for tb, vb in zip(train_batches, val_batches):
            wl = self.weight_step(tb)
            el = eval_logits_fn(vb) if eval_logits_fn else None
            al = self.alpha_step(vb, el)
            self.history.append({"weight_loss": wl, "alpha_loss": al})
        return self.genotype()
