"""Evaluation CLI: top-1/top-5 of a classifier on one card, counterpart of
`cream_tpu/cli/eval.py` (AutoFormerV2/evaluation.py, Cream/tools/test.py,
EfficientViT's and TinyViT's eval modes).

    python -m cream_tpu_torch.cli.eval model.name=tiny_vit_21m_224 \
        data.data_path=/data/imagenet --torch-ckpt tiny_vit_21m_22kto1k.pth
    python -m cream_tpu_torch.cli.eval --device cpu model.name=tiny_vit_5m_224 \
        model.dtype=float32 data.dataset=synthetic data.img_size=64

The val split of `cli.train.build_dataset` (an image folder, `val.zip` or
the synthetic set) goes through the JAX eval loader's bicubic resize and
centre crop (`data.crop`), and the model is built at `data.img_size`.
Weights: `--torch-ckpt` (a released-layout .pth through `zoo.load`; position
tables of a checkpoint at another resolution are bicubic-remapped, as
`zoo/interpolate` does for the JAX CLI), else seeded random weights
(`train.seed`), which check the pipeline and say nothing of accuracy.
Prints `acc@1= acc@5= n=` as the JAX CLI does.
"""
from __future__ import annotations

import argparse
import time
from types import SimpleNamespace

import torch

from cream_tpu_torch.cli.train import build_dataset, model_options
from cream_tpu_torch.core.config import Config
from cream_tpu_torch.data.imagenet import eval_loader, prefetch
from cream_tpu_torch.models import create_model
from cream_tpu_torch.train import make_eval_step, topk_accuracy_counts
from cream_tpu_torch.zoo.load import load_for_model, seeded_state_dict


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cfg", default=None)
    ap.add_argument("--torch-ckpt", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("opts", nargs="*")
    args = ap.parse_args(argv)
    cfg = Config.from_yaml(args.cfg, args.opts)
    device = torch.device(args.device)
    dtype = getattr(torch, cfg.model.dtype)
    model = create_model(cfg.model.name, num_classes=cfg.model.num_classes,
                         device=device, dtype=dtype, img_size=cfg.data.img_size,
                         **model_options(cfg))
    model.load_state_dict(load_for_model(model, args.torch_ckpt) if args.torch_ckpt
                          else seeded_state_dict(model, cfg.train.seed))
    eval_step = make_eval_step()
    state = SimpleNamespace(model=model)
    ds = build_dataset(cfg, train=False)
    results = []
    t0 = time.perf_counter()
    for b in prefetch(eval_loader(ds, cfg.data.batch_size, cfg.data.img_size,
                                  cfg.data.crop, num_workers=cfg.data.num_workers,
                                  native=cfg.data.native_loader)):
        results.append(eval_step(state, {
            "image": torch.from_numpy(b["image"]).to(device, dtype),
            "label": torch.from_numpy(b["label"]).to(device)}))
    acc = topk_accuracy_counts(results)
    acc["seconds"] = time.perf_counter() - t0
    print(f"acc@1={acc['acc1']:.3f} acc@5={acc['acc5']:.3f} n={acc['n']} "
          f"({acc['n'] / max(acc['seconds'], 1e-9):.1f} img/s, the loader included)")
    return acc


if __name__ == "__main__":
    main()
