"""Train state: the model (params + BatchNorm buffers), the optimizer, the
step count and an EMA of the params.

Counterpart of `cream_tpu/train/state.py`'s TrainState. The model is updated
in place; the EMA covers the params only, not the BN buffers, as in the JAX
package, and after each update becomes `e*d + p*(1-d)` with the new params.
"""
from __future__ import annotations

from typing import Mapping

import torch


class TrainState:
    def __init__(self, model: torch.nn.Module, tx, ema_decay: float = 0.0):
        self.model = model
        self.tx = tx
        self.step = 0
        self.ema_decay = ema_decay
        self.ema_params = ({n: p.detach().clone() for n, p in self.params.items()}
                           if ema_decay > 0 else None)

    @property
    def params(self) -> dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    @torch.no_grad()
    def apply_gradients(self, grads: Mapping[str, torch.Tensor]) -> "TrainState":
        params = self.params
        self.tx.step(params, grads)
        self.step += 1
        if self.ema_params is not None:
            d = self.ema_decay
            ema = list(self.ema_params.values())
            torch._foreach_mul_(ema, d)
            torch._foreach_add_(ema, [params[n] for n in self.ema_params], alpha=1.0 - d)
        return self

    def state_dict(self) -> dict:
        return {"step": self.step, "model": self.model.state_dict(),
                "tx": self.tx.state_dict(), "ema_params": self.ema_params}

    def load_state_dict(self, sd: dict) -> None:
        device = next(self.model.parameters()).device
        self.step = int(sd["step"])
        self.model.load_state_dict(sd["model"])
        self.tx.load_state_dict(sd["tx"])
        self.tx.to(device)
        ema = sd.get("ema_params")
        self.ema_params = (None if ema is None else
                           {k: t.to(device).clone() for k, t in ema.items()})
