"""The staged CDARTS search CLI (CDARTS/CDARTS/search.py).

Runs the whole staged campaign on one card (`nas.cdarts_stage.
MultiStageSearcher`): the supernet warmup, the joint optimization of alphas
and discretized-net weights with the interactive loss, layer-by-layer
discretization with super -> nas copies; writes the genotype history as
JSON ({"final_genotypes": [...], "history": [...]}, each genotype its
`_asdict()`), the JAX package's CLI's format, so either package reads the
other's output and `models.darts.cdarts_retrain_imagenet` builds from its
`final_genotypes`.

    python -m cream_tpu_torch.cli.search_cdarts --synthetic --out genotypes.json
    python -m cream_tpu_torch.cli.search_cdarts --cpu --synthetic --layers 2 \
        --cells 1 --channels 8 --nodes 2 --steps 2 --iters 1 --batch-size 8 \
        --aux-pool 4 --out genotypes.json         # seconds on the CPU

`--data-dir` takes a directory of (train|val)_images.npy (NHWC, [0, 255]
or [0, 1]) and (train|val)_labels.npy, the reference's split-in-half
CIFAR-10 protocol (search.py get_search_datasets); without it the batches
are synthetic, seeded. The search runs in fp32 on `--device` (default cuda;
`--cpu` is `--device cpu`).
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from cream_tpu_torch.nas.cdarts_stage import MultiStageSearcher, StageSearchConfig


def synthetic_batches(batch: int, num_classes: int, device, image: int = 32, n: int = 8,
                      seed: int = 0):
    """A callable giving an iterator over `n` seeded N(0, 1) batches (the JAX
    CLI's draws, on `device`)."""
    rng = np.random.default_rng(seed)
    data = [{"image": torch.as_tensor(rng.standard_normal((batch, image, image, 3)),
                                      dtype=torch.float32, device=device),
             "label": torch.as_tensor(rng.integers(0, num_classes, batch), device=device)}
            for _ in range(n)]
    return lambda: iter(data)


def npy_batches(path: str, split: str, batch: int, device):
    """A callable giving an iterator over the full batches of `split`."""
    images = np.load(os.path.join(path, f"{split}_images.npy"), mmap_mode="r")
    labels = np.load(os.path.join(path, f"{split}_labels.npy"))

    def gen():
        for i in range(0, len(labels) - batch + 1, batch):
            x = np.asarray(images[i:i + batch], np.float32)
            if x.max() > 2.0:
                x = x / 255.0
            yield {"image": torch.as_tensor(x, device=device),
                   "label": torch.as_tensor(labels[i:i + batch], device=device)}
    return gen


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--num-classes", type=int, default=10)
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--cells", type=int, default=2, help="cells per layer (reference cell_num)")
    ap.add_argument("--channels", type=int, default=16)
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--pretrain-epochs", type=int, default=1)
    ap.add_argument("--iters", type=int, default=2, help="search iters per layer stage")
    ap.add_argument("--steps", type=int, default=8, help="train/val steps per iter")
    ap.add_argument("--aux-pool", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="cdarts_genotypes.json")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (--device cpu)")
    args = ap.parse_args(argv)
    device = torch.device("cpu" if args.cpu else args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available "
                           "(--cpu runs on the CPU)")

    cfg = StageSearchConfig(
        layer_num=args.layers, cells_per_layer=args.cells, n_nodes=args.nodes,
        C=args.channels, num_classes=args.num_classes,
        pretrain_epochs=args.pretrain_epochs, search_iters=args.iters,
        steps_per_iter=args.steps, aux_pool_size=args.aux_pool)
    if args.synthetic or not args.data_dir:
        train_b = synthetic_batches(args.batch_size, args.num_classes, device, n=args.steps,
                                    seed=args.seed)
        val_b = synthetic_batches(args.batch_size, args.num_classes, device, n=args.steps,
                                  seed=args.seed + 1)
    else:
        train_b = npy_batches(args.data_dir, "train", args.batch_size, device)
        val_b = npy_batches(args.data_dir, "val", args.batch_size, device)

    searcher = MultiStageSearcher(cfg, device=device,
                                  generator=torch.Generator().manual_seed(args.seed))
    genotypes, history = searcher.run(train_b, val_b)
    result = {"final_genotypes": [g._asdict() for g in genotypes],
              "history": [{**h, "genotype": h["genotype"]._asdict()} for h in history]}
    with open(args.out, "w") as fh:
        json.dump(result, fh, indent=2, default=str)
    print(f"wrote {args.out}: {len(history)} search iters, {len(genotypes)} layer genotypes")
    return {**result, "timings": searcher.timings}


if __name__ == "__main__":
    main()
