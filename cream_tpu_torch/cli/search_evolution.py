"""AutoFormer evolution search CLI, on one card or several: counterpart of
`cream_tpu/cli/search_evolution.py` (AutoFormer/evolution.py).

A candidate's fitness is the top-1 of the trained supernet at its config on
the (sub-sampled) val set. The supernet's weights come from --ckpt (a
`cli.supernet_train` checkpoint directory) or --torch-ckpt (a reference
supernet .pth), as the reference restores the trained supernet before
searching (evolution.py:537-544); --allow-random searches seeded random
weights, for smoke tests only, and without any of the three the CLI
refuses. Candidates must lie in the parameter window [--param-min,
--param-max] (`config_param_count`). The one supernet object scores every
candidate, one by one; `--eval-chunk` (the JAX CLI's chunk of candidates
vmapped over its masked supernet) is accepted for that CLI's command lines
and has no effect. The window counts a config's params for this run's classes and patch
grid (the JAX CLI counts 1,000 classes and 196 patches whatever the run's;
the same at the defaults). Writes the JAX CLI's JSON (`top`, `state`),
which `--resume` reads.

    python -m cream_tpu_torch.cli.supernet_train --space tiny \
        data.dataset=synthetic data.batch_size=128 train.epochs=1 output=./af
    python -m cream_tpu_torch.cli.search_evolution --space tiny \
        --ckpt ./af/autoformer_supernet_tiny/default/ckpt \
        data.dataset=synthetic data.batch_size=256 \
        --param-min 5e6 --param-max 6e6 --epochs 2 --population 16 --out evo.json
    # deploy: models.autoformer.extract_subnet(supernet, best_config)

Data: the val split of `cli.train.build_dataset` (synthetic or an image
folder) through the eval resize and crop; `--evo-subset N` scores on the
per-class EVO_IMNET subset of a folder (`data.imagenet.sub_imagenet`, the
membership of AutoFormer/lib/subImageNet.py).

Under torchrun (`torchrun --nproc_per_node N -m cream_tpu_torch.cli.search_evolution
...`; gloo with `--device cpu`) each rank scores its strided share of a
candidate's batches (batch i on rank i mod N) and the correct counts are
summed over the ranks, as the JAX CLI's mesh splits each batch over its
devices; every rank runs the same seeded search, so N ranks find the one
card's candidates, scores and best config, and rank 0 writes the result.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from cream_tpu_torch.cli.train import build_dataset
from cream_tpu_torch.core import mesh
from cream_tpu_torch.core.checkpoint import restore_params
from cream_tpu_torch.core.config import Config
from cream_tpu_torch.data.imagenet import eval_loader, sub_imagenet
from cream_tpu_torch.models import create_model
from cream_tpu_torch.models.autoformer import SPACES, config_param_count, sample_config
from cream_tpu_torch.nas.evolution import (EvolutionSearcher, autoformer_crossover,
                                           autoformer_mutate)
from cream_tpu_torch.zoo.load import load_for_model, seeded_state_dict


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cfg", default=None)
    ap.add_argument("--space", default="tiny", choices=list(SPACES))
    ap.add_argument("--param-min", type=float, default=0)
    ap.add_argument("--param-max", type=float, default=1e12)
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--population", type=int, default=50)
    ap.add_argument("--max-eval-batches", type=int, default=20)
    ap.add_argument("--eval-chunk", type=int, default=8,
                    help="the JAX CLI's flag, accepted and without effect: candidates "
                         "are scored one by one")
    ap.add_argument("--evo-subset", type=int, default=0,
                    help="fixed per-class eval subset size (EVO_IMNET); 0 = off")
    ap.add_argument("--resume", default=None)
    ap.add_argument("--out", default="evolution_result.json")
    ap.add_argument("--ckpt", default=None, help="checkpoint dir from supernet_train")
    ap.add_argument("--torch-ckpt", default=None,
                    help="reference supernet .pth (evolution.py:537-544)")
    ap.add_argument("--allow-random", action="store_true",
                    help="smoke tests only: search a seeded random supernet")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("opts", nargs="*")
    args = ap.parse_args(argv)
    cfg = Config.from_yaml(args.cfg, args.opts)
    mesh.init_distributed(args.device)
    device = mesh.local_device(args.device)
    dtype = getattr(torch, cfg.model.dtype)
    space = SPACES[args.space]
    name = f"autoformer_supernet_{args.space}"
    model = create_model(name, num_classes=cfg.model.num_classes, img_size=cfg.model.img_size,
                         device=device, dtype=dtype)
    # the supernet must carry trained weights, as the reference loads them
    # before searching (AutoFormer/evolution.py:537-544)
    if args.torch_ckpt:
        model.load_state_dict(load_for_model(model, args.torch_ckpt))
    elif args.ckpt:
        model.load_state_dict(restore_params(args.ckpt))
    elif args.allow_random:
        model.load_state_dict(seeded_state_dict(model, 0))
    else:
        raise SystemExit(
            "refusing to search a RANDOM-init supernet: pass --ckpt (a supernet_train "
            "checkpoint dir) or --torch-ckpt (reference supernet .pth), or "
            "--allow-random for smoke tests only.")
    model.eval()

    ds = build_dataset(cfg, train=False)
    if args.evo_subset > 0 and hasattr(ds, "samples"):
        ds = sub_imagenet(ds, per_class=args.evo_subset)
    batches = []
    for i, b in enumerate(eval_loader(ds, cfg.data.batch_size, cfg.data.img_size,
                                      cfg.data.crop, num_workers=cfg.data.num_workers)):
        if i >= args.max_eval_batches:
            break
        if i % mesh.world_size() == mesh.rank():
            batches.append((torch.from_numpy(b["image"]).to(device, dtype),
                            torch.from_numpy(b["label"]).to(device)))
    n_images = int(mesh.all_reduce_sum(torch.tensor(
        sum(int((labels >= 0).sum()) for _, labels in batches), device=device)))
    num_patches = (cfg.model.img_size // model.patch_size) ** 2

    @torch.inference_mode()
    def eval_fn(config) -> float:
        correct = torch.zeros((), dtype=torch.int64, device=device)
        for images, labels in batches:
            logits = model(images, config=config)
            correct += ((logits.argmax(-1) == labels) & (labels >= 0)).sum()
        return int(mesh.all_reduce_sum(correct)) / max(n_images, 1)

    searcher = EvolutionSearcher(
        sample_fn=lambda rng: sample_config(rng, space),
        eval_fn=eval_fn,
        mutate_fn=lambda rng, c: autoformer_mutate(rng, c, space),
        crossover_fn=autoformer_crossover,
        is_legal_extra=lambda c: args.param_min <= config_param_count(
            c, cfg.model.num_classes, num_patches) <= args.param_max,
        population_num=args.population, max_epochs=args.epochs)
    if args.resume and os.path.exists(args.resume):
        with open(args.resume) as f:
            saved = json.load(f)
        # this CLI's own output holds the state under "state" (the JAX CLI
        # reads the file as the state itself, so it cannot resume from its
        # own output; both forms are taken here)
        searcher.load_state_dict(saved.get("state", saved))
    done = len(searcher.history)
    t0 = time.perf_counter()
    top = searcher.search()
    wall = time.perf_counter() - t0
    scored = len(searcher.history) - done
    if mesh.is_main_process():
        with open(args.out, "w") as f:
            json.dump({"top": [(s, c) for s, c in top], "state": searcher.state_dict()}, f,
                      default=str)
        print(f"evolution: {scored} candidates scored in {wall:.2f} s "
              f"({scored / max(wall, 1e-9):.2f} candidates/s, "
              f"{scored * n_images / max(wall, 1e-9):.1f} img/s over {n_images} images)")
        print("best:", top[0] if top else None)
    return top


if __name__ == "__main__":
    main()
