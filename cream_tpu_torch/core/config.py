"""Typed config system: dataclasses + YAML merge + dotted CLI overrides.

Counterpart of `cream_tpu/core/config.py` with the same keys, so a config
file or `model.name=...` override written for the JAX package works here.
PyYAML is imported only when a YAML file is given; dotted overrides are
parsed without it (numbers, true/false, null, JSON lists/dicts, else str).
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any


def _merge_into(obj, data: dict, path: str = ""):
    for k, v in data.items():
        key = k.lower()
        if not hasattr(obj, key):
            raise KeyError(f"unknown config key {path}{k}")
        cur = getattr(obj, key)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            _merge_into(cur, v, f"{path}{k}.")
        else:
            if cur is not None and v is not None and not isinstance(v, type(cur)) \
                    and not (isinstance(cur, (int, float)) and isinstance(v, (int, float))) \
                    and not (isinstance(cur, (tuple, list)) and isinstance(v, (tuple, list))):
                raise TypeError(f"config key {path}{k}: expected "
                                f"{type(cur).__name__}, got {type(v).__name__}")
            if isinstance(cur, tuple) and isinstance(v, list):
                v = tuple(v)
            setattr(obj, key, v)


def _parse_value(s: str) -> Any:
    for cast in (int, float):
        try:
            return cast(s)
        except ValueError:
            pass
    low = s.strip().lower()
    if low in ("true", "yes", "on"):
        return True
    if low in ("false", "no", "off"):
        return False
    if low in ("null", "~", ""):
        return None
    if low[:1] in ("[", "{"):
        try:
            return json.loads(s)
        except json.JSONDecodeError:
            pass
    return s


@dataclass
class ModelConfig:
    name: str = "tiny_vit_21m_224"
    num_classes: int = 1000
    img_size: int = 224
    drop_path_rate: float | None = None
    dtype: str = "bfloat16"
    extra: dict = field(default_factory=dict)     # family-specific kwargs


@dataclass
class DataConfig:
    dataset: str = "imagenet"
    data_path: str = ""
    batch_size: int = 128                          # per-host global batch
    img_size: int = 224
    num_workers: int = 8
    crop: bool = True                              # TEST.CROP semantics
    interpolation: str = "bicubic"
    # route pixel work through native/libimage_pipe.so where the transform
    # allows it ("auto" = if built; see data/native_pipe.py)
    native_loader: str | bool = False


@dataclass
class AugConfig:
    mixup: float = 0.8
    cutmix: float = 1.0
    mixup_switch_prob: float = 0.5
    label_smoothing: float = 0.1
    color_jitter: float = 0.4
    auto_augment: str = "rand-m9-mstd0.5-inc1"
    reprob: float = 0.25                           # random erasing
    remode: str = "pixel"
    recount: int = 1
    repeated_aug: int = 0                          # RASampler repetitions
    hflip: float = 0.5


@dataclass
class TrainConfig:
    epochs: int = 300
    warmup_epochs: int = 20
    base_lr: float = 1e-3
    warmup_lr: float = 1e-7
    min_lr: float = 1e-6
    weight_decay: float = 0.05
    clip_grad: float = 5.0
    layer_lr_decay: float = 1.0
    optimizer: str = "adamw"
    ema_decay: float = 0.0
    accumulation_steps: int = 1
    auto_resume: bool = True
    seed: int = 0
    # NaN-loss policy: 0 = exit on first NaN (AutoFormer supernet_engine.py:
    # 87-89); N>0 tolerates a budget like TinyCLIP (train.py:86 NAN_LOSS_CNT)
    nan_budget: int = 10
    tensorboard: bool = False
    wandb_project: str = ""


@dataclass
class DistillConfig:
    enabled: bool = False
    teacher: str = ""
    teacher_logits_path: str = ""
    logits_topk: int = 100
    kind: str = "soft"                             # none|soft|hard
    alpha: float = 0.5
    tau: float = 1.0


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    aug: AugConfig = field(default_factory=AugConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    distill: DistillConfig = field(default_factory=DistillConfig)
    output: str = "output"
    tag: str = "default"

    @classmethod
    def from_yaml(cls, path: str | None = None, opts: list[str] | None = None
                  ) -> "Config":
        cfg = cls()
        if path:
            import yaml
            with open(path) as f:
                data = yaml.safe_load(f) or {}
            base = data.pop("BASE", data.pop("base", None))
            if base:
                for b in ([base] if isinstance(base, str) else base):
                    parent = cls.from_yaml(os.path.join(os.path.dirname(path), b))
                    cfg = parent
            _merge_into(cfg, data)
        for kv in opts or []:
            k, _, v = kv.partition("=")
            node = cfg
            *parents, leaf = k.lower().split(".")
            for p in parents:
                node = getattr(node, p)
            _merge_into(node, {leaf: _parse_value(v)})
        return cfg

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)
