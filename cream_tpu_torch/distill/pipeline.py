"""Fast-pretraining-distillation train step (TinyViT).

Counterpart of `cream_tpu/distill/pipeline.py` (the student side of
TinyViT/main.py:284-400, train_one_epoch_distill_using_saved_logits): the
dense teacher distribution is rebuilt from the saved top-K
(`losses.dense_from_topk`) and the student trains with soft-target CE on
its fp32 logits. The forward and backward are `train.steps.loss_and_grads`,
so on the card the student's window attention runs K1/K2; under a
data-parallel group the step averages over the ranks as
`train.steps.make_train_step` does (`data_parallel_mean`).
"""
from __future__ import annotations

import dataclasses
import json

import torch

from cream_tpu_torch.data.det_aug import train_aug_config
from cream_tpu_torch.train.losses import dense_from_topk, soft_target_ce
from cream_tpu_torch.train.optim import global_norm
from cream_tpu_torch.train.state import TrainState
from cream_tpu_torch.train.steps import data_parallel_mean, loss_and_grads, step_generator


def _fp32_soft_target_ce(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return soft_target_ce(logits.float(), target)


def make_distill_train_step(num_classes: int):
    """Returns step(state, batch, seed=0) -> (state, metrics) for batches
    {image (B, H, W, C), topk_values (B, K) fp32, topk_indices (B, K) int}
    on the model's device. Drop path and dropout draw from
    `step_generator(seed, state.step)`. metrics: 'loss', 'teacher_agree'
    (the share of images whose argmax is the teacher's top class) and
    'grad_norm' (the raw grads' global norm, before clipping), the global
    batch's under a data-parallel group."""

    def step(state: TrainState, batch, seed: int = 0):
        gen = step_generator(seed, state.step, batch["image"].device)
        target = dense_from_topk(batch["topk_values"], batch["topk_indices"], num_classes)
        loss, logits, grads = loss_and_grads(
            state.model, {"image": batch["image"], "label": target},
            _fp32_soft_target_ce, gen)
        agree = (logits.argmax(-1) == batch["topk_indices"][:, 0]).float().mean()
        metrics = {"loss": loss, "teacher_agree": agree}
        data_parallel_mean(grads, metrics)
        state.apply_gradients(grads)
        return state, {**metrics, "grad_norm": global_norm(grads.values())}

    return step


def replay_recipe(cfg) -> dict:
    """What a teacher (save_logits) and a student (the distill trainer) of
    this package see for a config: the writer, the pixel transform (the
    seeded train recipe `det_aug.make_train_transform` and its
    `TrainAugConfig`) and the seeded pair mixup's stream and settings (None
    when mixup and cutmix are off), in its JSON form. A store is replayed
    only under an equal recipe (`check_recipe`)."""
    mixing = cfg.aug.mixup > 0 or cfg.aug.cutmix > 0
    return json.loads(json.dumps({
        "writer": "cream_tpu_torch",
        "pixels": {"transform": "cream_tpu_torch.data.det_aug.make_train_transform",
                   "config": dataclasses.asdict(train_aug_config(cfg))},
        "mixup": ({"stream": "cream_tpu_torch.data.mixup.seeded_pair_mixup: a CPU "
                             "torch.Generator per pair, seeded seeds[2i] ^ seeds[2i+1]",
                   "mixup": cfg.aug.mixup, "cutmix": cfg.aug.cutmix,
                   "switch_prob": cfg.aug.mixup_switch_prob} if mixing else None),
    }))
