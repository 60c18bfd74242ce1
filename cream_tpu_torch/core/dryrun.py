"""Multi-card dry run of the data-parallel paths, and the launcher of ranks.

Counterpart of the JAX package's `dryrun_multichip` (`__graft_entry__.py`):
`dryrun_multichip(n)` starts n ranks, one process each (NCCL on n cards;
gloo processes with `device="cpu"`), and each runs the JAX dry run's three
checks (the third where n is even, as in JAX):

  1. one data-parallel train step of TinyViT-5M (16 classes, 64 x 64
     images, a global batch of 2n: 2 rows a rank) with AdamW(1e-3, weight
     decay 0.05) and an EMA of 0.999: the step count is 1 and the loss is
     finite;
  2. CLIP's contrastive loss over a global batch of 4n features gathered
     from the ranks (`distill.clip_losses` with the group): its gradient
     flows back through the gather and is finite;
  3. tensor × data parallelism: the ranks split into a (data, model)
     layout with JAX's choice, model = 4 where n divides by 4, else 2, and
     data = n // model (`core.mesh.init_distributed(device, model=)`); a
     CLIP whose blocks are split by heads over the model group
     (`core.tensor_parallel`, `CLIP_TP_RULES`) takes one contrastive grad
     step on 2 rows a data rank (zero images, token ids of ones, as JAX's):
     the loss is finite and `in_proj_weight`'s grad on each rank has the
     shard's shape. JAX's check runs a 2-head CLIP of width 128, whose
     fused in_proj columns XLA splits anywhere; the port splits whole heads,
     so it takes width 256 in both towers: 4 heads of 64, which divide by
     either model size.

    python -c "from cream_tpu_torch.core.dryrun import dryrun_multichip; \
dryrun_multichip(2, device='cpu')"
"""
from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

PACKAGE_PARENT = Path(__file__).resolve().parents[2]
CLIP_BATCH, CLIP_DIM, CLIP_SCALE = 4, 16, 50.0
# the third check's CLIP: JAX's dry-run config at width 256 (4 heads a tower)
TP_CLIP = dict(embed_dim=64, vision_width=256, vision_layers=2, vision_patch=16,
               image_size=64, text_width=256, text_layers=2, text_heads=4,
               context_length=16, vocab_size=1000)


def tp_layout(n: int) -> tuple[int, int]:
    """(data, model) of the third check on n ranks: JAX's choice."""
    tp = 4 if n % 4 == 0 else 2
    return n // tp, tp


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_ranks(n: int, argv: list[str], timeout: float = 900.0,
                 cwd: str | None = None) -> list[str]:
    """Run `python <argv>` as ranks 0..n-1 of one group, with the
    environment torchrun gives its processes (`RANK`, `WORLD_SIZE`,
    `LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT` on a free local port), the
    package importable, one OpenMP thread each. Waits for all; returns
    their outputs, or raises with the output of the first that failed."""
    port = free_port()
    path = os.pathsep.join(p for p in (str(PACKAGE_PARENT), os.environ.get("PYTHONPATH"))
                           if p)
    procs = []
    for r in range(n):
        env = {**os.environ, "RANK": str(r), "LOCAL_RANK": str(r), "WORLD_SIZE": str(n),
               "LOCAL_WORLD_SIZE": str(n), "MASTER_ADDR": "127.0.0.1",
               "MASTER_PORT": str(port), "PYTHONPATH": path, "OMP_NUM_THREADS": "1"}
        procs.append(subprocess.Popen([sys.executable, *argv], env=env, cwd=cwd,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} of {n} failed (rc {p.returncode}):\n{out[-4000:]}")
    return outs


def clip_features(n: int) -> tuple[np.ndarray, np.ndarray]:
    """The contrastive check's global batch: (4n, 16) image and text
    features, L2-normalized rows, from a fixed seed."""
    rng = np.random.default_rng(3)
    img, txt = (rng.standard_normal((CLIP_BATCH * n, CLIP_DIM)).astype(np.float32)
                for _ in range(2))
    return (img / np.linalg.norm(img, axis=-1, keepdims=True),
            txt / np.linalg.norm(txt, axis=-1, keepdims=True))


def dryrun_multichip(n: int, device: str = "cuda", timeout: float = 900.0) -> dict:
    """Run the dry run's checks on n ranks (see the module's doc); raises
    if a check fails or, on CUDA, if fewer than n cards are present.
    Returns rank 0's step metrics, the contrastive check's inputs, loss and
    gradient (the ranks' rows in rank order), and the third check's layout,
    loss and every rank's `in_proj_weight` grad shape (None for odd n)."""
    if torch.device(device).type == "cuda":
        if torch.cuda.device_count() < n:
            raise RuntimeError(f"dryrun_multichip({n}) needs {n} cards, "
                               f"found {torch.cuda.device_count()}")
        from cream_tpu_torch.ops import build
        build.build()                  # once, before the ranks load it
    with tempfile.TemporaryDirectory() as out:
        launch_ranks(n, ["-m", "cream_tpu_torch.core.dryrun", "--device", device,
                         "--out", out], timeout)
        ranks = [dict(np.load(os.path.join(out, f"rank{r}.npz"))) for r in range(n)]
    img, txt = clip_features(n)
    tp = None
    if n % 2 == 0:
        tp = {"layout": tp_layout(n), "loss": float(ranks[0]["tp_loss"]),
              "in_proj_grad_shapes": [tuple(int(d) for d in r["tp_grad_shape"])
                                      for r in ranks]}
    return {"loss": float(ranks[0]["loss"]), "step": int(ranks[0]["step"]),
            "grad_norm": float(ranks[0]["grad_norm"]),
            "contrastive": {"image": img, "text": txt, "scale": CLIP_SCALE,
                            "loss": float(ranks[0]["clip_loss"]),
                            "grad": np.concatenate([r["clip_grad"] for r in ranks])},
            "tensor_parallel": tp}


def _rank_main(device: str, out: str) -> None:
    """One rank of the dry run: its checks, then its results to
    `out/rank<r>.npz`."""
    from cream_tpu_torch.core import mesh
    from cream_tpu_torch.distill.clip_losses import clip_contrastive_loss
    from cream_tpu_torch.models import create_model
    from cream_tpu_torch.train import TrainState, make_adamw, make_train_step
    from cream_tpu_torch.zoo.load import seeded_state_dict

    mesh.init_distributed(device)
    dev = mesh.local_device(device)
    r, n = mesh.rank(), mesh.world_size()

    model = create_model("tiny_vit_5m_224", num_classes=16, img_size=64, device=dev,
                         dtype=torch.float32)
    model.load_state_dict(seeded_state_dict(model, 0))
    mesh.broadcast_module(model)
    state = TrainState(model, make_adamw(1e-3, weight_decay=0.05, clip_grad=None),
                       ema_decay=0.999)
    batch = {"image": torch.ones(2, 64, 64, 3, device=dev),
             "label": torch.zeros(2, dtype=torch.int64, device=dev)}
    state, metrics = make_train_step()(state, batch, 1)
    loss = float(metrics["loss"])
    if state.step != 1 or not np.isfinite(loss):
        raise RuntimeError(f"dry run step: step {state.step}, loss {loss}")

    img, txt = clip_features(n)
    rows = slice(r * CLIP_BATCH, (r + 1) * CLIP_BATCH)
    a = torch.from_numpy(img[rows]).to(dev).requires_grad_()
    clip_loss = clip_contrastive_loss(a, torch.from_numpy(txt[rows]).to(dev),
                                      torch.tensor(CLIP_SCALE, device=dev),
                                      group=mesh.data_group())
    (grad,) = torch.autograd.grad(clip_loss, a)
    if not bool(torch.isfinite(grad).all()):
        raise RuntimeError("dry run contrastive gradient not finite")
    res = dict(loss=loss, step=state.step, grad_norm=float(metrics["grad_norm"]),
               clip_loss=float(clip_loss), clip_grad=grad.cpu().numpy())
    if n % 2 == 0:
        res.update(_tp_check(device, dev, n))
    np.savez(os.path.join(out, f"rank{r}.npz"), **res)
    mesh.barrier()
    torch.distributed.destroy_process_group()


def _tp_check(device: str, dev: torch.device, n: int) -> dict:
    """The third check on this rank (see the module's doc)."""
    from cream_tpu_torch.core import mesh
    from cream_tpu_torch.core.tensor_parallel import current_shard
    from cream_tpu_torch.models.clip import CLIP, CLIPConfig, split_clip
    from cream_tpu_torch.train.steps import contrastive_loss_and_grads
    from cream_tpu_torch.zoo.load import seeded_state_dict

    data, tp = tp_layout(n)
    mesh.init_distributed(device, model=tp)
    full = CLIP(CLIPConfig(**TP_CLIP), device=dev)
    full.load_state_dict(seeded_state_dict(full, 4))
    model = split_clip(full, current_shard())
    ctx, size = TP_CLIP["context_length"], TP_CLIP["image_size"]
    loss, grads = contrastive_loss_and_grads(
        model, torch.zeros(2, size, size, 3, device=dev),
        torch.ones(2, ctx, dtype=torch.int64, device=dev))
    g = grads["visual.transformer.resblocks.0.attn.in_proj_weight"]
    want = (3 * TP_CLIP["vision_width"] // tp, TP_CLIP["vision_width"])
    if not np.isfinite(float(loss)) or tuple(g.shape) != want:
        raise RuntimeError(f"dry run tensor parallelism ({data}, {tp}): loss {float(loss)}, "
                           f"in_proj grad {tuple(g.shape)}, want {want}")
    return {"tp_loss": float(loss), "tp_grad_shape": np.asarray(g.shape)}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    _rank_main(args.device, args.out)
