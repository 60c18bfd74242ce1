"""Whether `chip_smoke.check_tp_grads`' per-tensor bound tells a broken
tensor-parallel backward from rounding: a narrow CLIP (width 256, 4 heads a
tower, 2 layers) split over a model axis of 2 on 2 gloo ranks, its first
contrastive grads gathered whole and held against the unsplit model's, with
`copy_to_model`'s backward intact and with its sum over the model group
left out.

    PYTHONPATH=. torchrun --nproc_per_node 2 tools/torch_tp_grad_bound.py [--dtype bf16]

Prints, on rank 0, each run's worst |diff| / |grad| and its tensor, and
whether the check passed.
"""
from __future__ import annotations

import argparse

import torch

import chip_smoke
from cream_tpu_torch.core import mesh
from cream_tpu_torch.core import tensor_parallel as tp
from cream_tpu_torch.models.clip import CLIP, CLIPConfig, split_clip
from cream_tpu_torch.train.steps import contrastive_loss_and_grads
from cream_tpu_torch.zoo.load import seeded_state_dict

CFG = dict(embed_dim=64, vision_width=256, vision_layers=2, vision_patch=16, image_size=64,
           text_width=256, text_layers=2, text_heads=4, context_length=16, vocab_size=1000)


def worst_grad(full, images, text, want) -> str:
    got = chip_smoke.tp_grads(split_clip(full, tp.current_shard()), images, text)
    try:
        return f"worst {chip_smoke.check_tp_grads('split', got, want):.3g}: passed"
    except RuntimeError as e:
        return f"failed ({e})"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dtype", choices=("bf16", "fp32"), default="bf16")
    args = ap.parse_args()
    torch.set_num_threads(1)
    mesh.init_distributed("cpu", model=2)
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    full = CLIP(CLIPConfig(**CFG), device="cpu", dtype=dtype)
    full.load_state_dict(seeded_state_dict(full, 0))
    gen = torch.Generator().manual_seed(0)
    images = torch.randn(16, 64, 64, 3, generator=gen)
    text = torch.randint(1, 998, (16, 16), generator=gen)
    text[:, -1] = 999
    # the data axis is 1, so the unsplit model's loss is the global batch's
    _, want = contrastive_loss_and_grads(full, images, text)
    want = {k: v.float() for k, v in want.items()}
    intact = worst_grad(full, images, text, want)
    tp._CopyToModel.backward = staticmethod(lambda ctx, grad: (grad, None))
    broken = worst_grad(full, images, text, want)
    if mesh.rank() == 0:
        print(f"{args.dtype}: intact {intact}; copy_to_model's backward sum left out {broken}")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
