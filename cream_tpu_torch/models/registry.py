"""Model registry: name -> factory building an eval-mode nn.Module."""
from __future__ import annotations

import inspect
from typing import Callable

import torch

_REGISTRY: dict[str, Callable] = {}


def register_model(fn: Callable | None = None, *, name: str | None = None):
    def _register(f: Callable):
        key = name or f.__name__
        if key in _REGISTRY:
            raise ValueError(f"model '{key}' already registered")
        _REGISTRY[key] = f
        return f
    if fn is not None:
        return _register(fn)
    return _register


def create_model(name: str, *, device, dtype: torch.dtype = torch.float32,
                 **kwargs) -> torch.nn.Module:
    """Build a registered model on `device` (params float32, compute in
    `dtype`), in eval mode. A CUDA device on a machine without one raises."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown model '{name}'; known: {sorted(_REGISTRY)}")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return _REGISTRY[name](device=device, dtype=dtype, **kwargs).eval()


def accepts(name: str, kwarg: str) -> bool:
    """Whether the factory of model `name` takes the keyword `kwarg` by name."""
    return kwarg in inspect.signature(_REGISTRY[name]).parameters


def list_models(prefix: str = "") -> list[str]:
    return sorted(k for k in _REGISTRY if k.startswith(prefix))
