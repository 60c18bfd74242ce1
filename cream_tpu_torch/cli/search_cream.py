"""Cream's prioritized-path search campaign on one card: counterpart of
`cream_tpu/cli/search_cream.py` (Cream/tools/train.py + lib/core/
train.py:28-113).

  * the stage depths sized from the FLOPs window (`nas.flops.
    search_for_layer`, lib/utils/search_structure_supernet.py:6-44);
  * each step: a student path (board-probability-biased, FLOPs-window
    rejection), a prioritized teacher picked by the meta head once the board
    holds paths, the meta-weighted KD + CE supernet step (SGD 0.9), the meta
    head's step (Adam) and the candidate's evaluation into the board;
  * at the end the board's best path is extracted as a childnet
    (`models.cream.extract_childnet`) and its logits held to the
    supernet's on that path (max-abs <= 1e-4, fp32).

    python -m cream_tpu_torch.cli.search_cream --device cpu --flops-min 4e6 \
        --flops-max 12e6 --epochs 2 --steps 4 --meta-sta-epoch 0 --lr 0.01 \
        --batch-size 8 --num-classes 8 --img-size 64 --out cream.json

(the board takes candidates only at epochs past --meta-sta-epoch, as the
reference's PrioritizedBoard does.) Synthetic data: N(0, 1) images and
uniform labels from numpy's default_rng(seed) (and seed + 1 for the val
batches), as the JAX CLI draws them; fp32; seeded random weights.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from cream_tpu_torch.models.cream import CreamSupernet, MetaMatchingHead, extract_childnet
from cream_tpu_torch.nas.cream import (PrioritizedBoard, make_cream_train_step,
                                       make_meta_update_step, sample_architecture)
from cream_tpu_torch.nas.flops import (arch_flops, build_flops_op_dict, build_flops_table,
                                       search_for_layer, sized_stages)
from cream_tpu_torch.train import TrainState
from cream_tpu_torch.train.optim import make_adamw, make_sgd
from cream_tpu_torch.zoo.load import seeded_state_dict


def synthetic_batches(batch: int, num_classes: int, img: int, n: int, seed: int, device
                      ) -> list[dict]:
    rng = np.random.default_rng(seed)
    return [{"image": torch.from_numpy(rng.standard_normal((batch, img, img, 3))
                                       .astype(np.float32)).to(device),
             "label": torch.from_numpy(rng.integers(0, num_classes, batch)).to(device)}
            for _ in range(n)]


def meta_step_slice(args) -> int:
    return max(2, args.batch_size // 4)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--flops-min", type=float, default=15e6)
    ap.add_argument("--flops-max", type=float, default=600e6)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--num-classes", type=int, default=1000)
    ap.add_argument("--img-size", type=int, default=224,
                    help="overrides search_for_layer's sized resolution")
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--meta-lr", type=float, default=1e-4)
    ap.add_argument("--meta-sta-epoch", type=int, default=1)
    ap.add_argument("--pool-size", type=int, default=10)
    ap.add_argument("--max-sample-tries", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="cream_search.json")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    # 1) size the stage depths from the FLOPs window
    op_dict = build_flops_op_dict(args.img_size)
    sta_num, sized_res = search_for_layer(op_dict, args.flops_min, args.flops_max)
    if sta_num is None:
        raise SystemExit("FLOPs window unsatisfiable (search_for_layer)")
    stages = sized_stages(sta_num)
    img = args.img_size or sized_res
    print(f"sta_num={sta_num} resolution={sized_res} -> stages={stages}")

    sl = meta_step_slice(args)
    model = CreamSupernet(num_classes=args.num_classes, stages=stages, img_size=img,
                          device=device)
    model.load_state_dict(seeded_state_dict(model, args.seed))
    # the meta head flattens its input (forward_meta): its width is the KD
    # slice's size x the classes
    meta = MetaMatchingHead(sl * args.num_classes, device=device)
    meta.load_state_dict(seeded_state_dict(meta, args.seed + 1))
    table = build_flops_table(img, stages=stages)
    layers_per_stage = [d for _, d, _ in stages]

    rng = np.random.default_rng(args.seed)
    batches = synthetic_batches(args.batch_size, args.num_classes, img, args.steps,
                                args.seed, device)
    val_batches = synthetic_batches(args.batch_size, args.num_classes, img, args.steps,
                                    args.seed + 1, device)
    sample_architecture(rng, layers_per_stage)     # the JAX CLI's init path draw

    state = TrainState(model, make_sgd(args.lr, momentum=0.9))
    meta_tx = make_adamw(args.meta_lr, weight_decay=0.0, clip_grad=None)
    step_fn = make_cream_train_step()
    meta_step = make_meta_update_step(model, meta, sgd_lr=args.lr, slice_size=sl)
    board = PrioritizedBoard(pool_size=args.pool_size, meta_sta_epoch=args.meta_sta_epoch)

    @torch.no_grad()
    def eval_logits(x, arch):
        model.eval()
        return model(x, config=arch).float()

    def sample_in_window(prob):
        for _ in range(args.max_sample_tries):
            cand = sample_architecture(rng, layers_per_stage, prob=prob)
            fl = arch_flops(cand, table)
            if args.flops_min <= fl <= args.flops_max * 10:
                return cand, fl
        return cand, fl  # give up: the last sample

    t0 = time.time()
    history = []
    for epoch in range(args.epochs):
        for batch, vbatch in zip(batches, val_batches):
            cand, fl = sample_in_window(board.op_probability())
            with torch.no_grad():
                mv, t_arch = board.select_teacher(eval_logits, lambda d: meta(d), cand)
            use_kd = t_arch is not None
            a_t = t_arch if use_kd else cand
            state, metrics = step_fn(state, batch, cand, a_t, mv if use_kd else 0.0, use_kd)
            if use_kd and epoch > args.meta_sta_epoch:
                t_probs = torch.softmax(eval_logits(batch["image"][:sl], a_t), -1)
                _, g = meta_step(batch["image"], batch["label"], cand, a_t, t_probs)
                meta_tx.step(dict(meta.named_parameters()), g)
            # the candidate's evaluation and the board's update
            logits = eval_logits(vbatch["image"], cand)
            prec1 = float((logits.argmax(-1) == vbatch["label"]).float().mean()) * 100
            t_logits = torch.softmax(eval_logits(vbatch["image"][:sl], cand), -1)
            board.update(epoch, prec1, fl, cand, inputs=vbatch["image"][:sl], logits=t_logits)
        history.append({"epoch": epoch, "loss": float(metrics["loss"]), "board": len(board),
                        "best_prec1": board.board[0].prec1 if len(board) else None})
        print(f"[{time.time() - t0:6.1f}s] epoch {epoch}: loss {float(metrics['loss']):.3f} "
              f"board {len(board)}", flush=True)

    if not len(board):
        raise SystemExit("board empty: raise --epochs past --meta-sta-epoch")
    best = board.board[0]
    child = extract_childnet(model, best.arch)
    # the extracted childnet must give the supernet's logits on its path
    x = val_batches[0]["image"][:2]
    with torch.no_grad():
        err = float((eval_logits(x, best.arch) - child(x).float()).abs().max())
    if not err < 1e-4:
        raise RuntimeError(f"childnet parity failed: {err}")
    result = {"sta_num": sta_num, "resolution": sized_res,
              "best_arch": [int(a) for a in np.asarray(best.arch).ravel()],
              "best_prec1": best.prec1, "best_flops": best.flops,
              "childnet_parity_maxdiff": err, "history": history}
    with open(args.out, "w") as fh:
        json.dump(result, fh, indent=2)
    print(f"wrote {args.out}; childnet parity maxdiff {err:.2e}")
    return result


if __name__ == "__main__":
    main()
