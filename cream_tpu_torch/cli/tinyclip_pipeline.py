"""TinyCLIP's multi-stage compression pipeline as one command.

Counterpart of `cream_tpu/cli/tinyclip_pipeline.py`: the reference's staged
recipe (TinyCLIP/src/training/main.py:326-371 and
script/auto_weight_inherit_100to75.sh -> 75to50.sh). Each stage

  1. affinity-distills the current model against a frozen copy of itself
     (the stage's teacher) while the L0 hard-concrete gates learn masks
     toward the stage's target sparsity (the lagrangian with multiplier
     ascent, the sparsity warmup);
  2. fuses the masks: `prune_clip` materializes the pruned towers (gate
     values folded into the weights, channels removed);
  3. hands the pruned model to the next stage as its student and teacher.

`--manual-inherit` instead shrinks widths and depths by the target ratio
and front-slices the weights (`distill.weight_inherit`).

    python -m cream_tpu_torch.cli.tinyclip_pipeline --synthetic \\
        --sparsities 0.25 0.333 --steps 30 --batch-size 8 \\
        --l0-lr 0.5 --l0-init-mean 2.0 --out tinyclip_stages

runs on the card (`--device cpu` runs it on the CPU). The weights are
seeded (`zoo.load.seeded_state_dict`) and the pairs synthetic, as the JAX
package's smoke run; `--l0-init-mean 10` is the reference's init, from
which short runs cannot move the gates. Each stage's model is written to
`stage_<i>.pt` (a state_dict in open_clip's names; `zoo.load.
load_pruned_clip` builds its ragged model), the param counts to
`report.json`. `--save-every N` writes a mid-stage checkpoint (weights, gates
and multipliers, both optimizers, the noise generator, the step) that a
restarted run resumes from; `--stop-after N` ends the run after N steps of a
stage, as a kill would.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os

import numpy as np
import torch

from cream_tpu_torch.distill.clip_losses import clip_contrastive_loss, clip_soft_loss
from cream_tpu_torch.distill.l0 import (L0Config, init_l0_params, lagrangian_loss, named_l0,
                                        negate_lambda_grads, sample_masks)
from cream_tpu_torch.distill.weight_inherit import weight_inherit
from cream_tpu_torch.models.clip import CLIP, CLIPConfig, prune_clip
from cream_tpu_torch.train.optim import AdamW


def tower_l0_cfg(width: int, layers: int, heads: int,
                 types=("hidden", "heads", "intermediate"),
                 heads_per_layer=None, mlp_per_layer=None) -> L0Config:
    """The auto-inheritance recipe's gate types (hidden/heads/intermediate;
    add "layer" for whole-branch gates). `heads_per_layer`/`mlp_per_layer`
    describe a ragged (already pruned) tower."""
    return L0Config(hidden_size=width, intermediate_size=width * 4,
                    num_attention_heads=max(1, heads), num_hidden_layers=layers,
                    pruning_types=tuple(types), heads_per_layer=heads_per_layer,
                    intermediate_per_layer=mlp_per_layer)


def clip_l0_cfgs(model: CLIP, prune_text: bool = True) -> dict[str, L0Config]:
    """The gate configs of `model`'s towers ("v", and "t" with
    `prune_text`), ragged where the model was built ragged."""
    c = model.cfg
    tup = lambda x: None if x is None else tuple(x)
    cfgs = {"v": tower_l0_cfg(c.vision_width, c.vision_layers, c.vision_width // 64,
                              heads_per_layer=tup(model.vision_heads),
                              mlp_per_layer=tup(model.vision_mlp_widths))}
    if prune_text:
        cfgs["t"] = tower_l0_cfg(c.text_width, c.text_layers, c.text_heads,
                                 heads_per_layer=tup(model.text_heads_per_layer),
                                 mlp_per_layer=tup(model.text_mlp_widths))
    return cfgs


def synthetic_pairs(batch: int, image_size: int, ctx: int, n: int, seed: int = 0
                    ) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """`n` (images, token ids) pairs on the CPU, drawn as the JAX package
    draws them: N(0, 1) NHWC images, ids in [1, 1000)."""
    rng = np.random.default_rng(seed)
    return [(torch.from_numpy(rng.standard_normal((batch, image_size, image_size, 3))
                              .astype(np.float32)),
             torch.from_numpy(rng.integers(1, 1000, (batch, ctx))))
            for _ in range(n)]


def n_params(state_dict) -> int:
    return sum(int(v.numel()) for v in state_dict.values())


class L0Distill:
    """One stage's L0 distillation: the student (trained in place), a
    frozen teacher that is a copy of the student's starting weights, the
    gates and multipliers of each pruned tower, and two optimizers with
    optax's Adam semantics (`AdamW` without decay): `lr` on the weights,
    `l0_lr` on the gates and multipliers, whose grads are negated so that
    the multipliers ascend. `step` is one step of the JAX package's
    `run_stage` (and of `bench.py`'s `tinyclip_train`): the soft loss,
    plus `contrastive_weight` times the contrastive loss, plus each
    tower's lagrangian; the masks are sampled for each tower from one
    generator in turn, so the towers' noise is independent."""

    def __init__(self, student: CLIP, *, lr: float, l0_lr: float, target_sparsity: float,
                 sparsity_warmup: int, contrastive_weight: float = 1.0,
                 l0_init_mean: float = 10.0, prune_text: bool = True):
        self.student = student
        self.teacher = copy.deepcopy(student).requires_grad_(False)
        self.cfgs = clip_l0_cfgs(student, prune_text)
        device = student.logit_scale.device
        self.l0 = {k: init_l0_params(c, l0_init_mean, device) for k, c in self.cfgs.items()}
        self.target_sparsity, self.sparsity_warmup = target_sparsity, sparsity_warmup
        self.contrastive_weight = contrastive_weight
        self.opt_model = AdamW(lr, weight_decay=0.0)
        self.opt_l0 = AdamW(l0_lr, weight_decay=0.0)
        self.steps = 0

    def named_l0(self) -> dict[str, torch.Tensor]:
        return {n: t for k, p in self.l0.items() for n, t in named_l0(p, f"{k}.").items()}

    def loss(self, images, text, *, generator=None, uniforms=None):
        """(loss, {tower: expected sparsity}) at the current weights."""
        masks = {k: sample_masks(p, generator=generator,
                                 uniforms=None if uniforms is None else uniforms[k])
                 for k, p in self.l0.items()}
        img, txt, scale = self.student(images, text, masks["v"], masks.get("t"))
        with torch.no_grad():
            t_img, t_txt, t_scale = self.teacher(images, text)
        loss = clip_soft_loss(img, txt, scale, t_img, t_txt, t_scale)
        if self.contrastive_weight:
            loss = loss + self.contrastive_weight * clip_contrastive_loss(img, txt, scale)
        sparsity = {}
        for k, p in self.l0.items():
            lag, sparsity[k], _ = lagrangian_loss(p, self.cfgs[k], self.target_sparsity,
                                                  self.steps, self.sparsity_warmup)
            loss = loss + lag
        return loss, sparsity

    def step(self, images, text, *, generator=None, uniforms=None):
        """One update; returns the step's (loss, {tower: sparsity}),
        detached, as read before the update."""
        loss, sparsity = self.loss(images, text, generator=generator, uniforms=uniforms)
        params = dict(self.student.named_parameters())
        l0 = self.named_l0()
        grads = torch.autograd.grad(loss, [*params.values(), *l0.values()],
                                    allow_unused=True, materialize_grads=True)
        self.opt_model.step(params, dict(zip(params, grads[:len(params)])))
        self.opt_l0.step(l0, negate_lambda_grads(dict(zip(l0, grads[len(params):]))))
        self.steps += 1
        return loss.detach(), {k: s.detach() for k, s in sparsity.items()}

    def masks(self) -> dict:
        """The deterministic (inference) masks of each tower."""
        return {k: sample_masks(p, training=False) for k, p in self.l0.items()}

    def state_dict(self) -> dict:
        return {"model": self.student.state_dict(),
                "l0": {k: t.detach() for k, t in self.named_l0().items()},
                "opt_model": self.opt_model.state_dict(), "opt_l0": self.opt_l0.state_dict(),
                "steps": self.steps}

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        self.student.load_state_dict(sd["model"])
        for k, t in self.named_l0().items():
            t.copy_(sd["l0"][k])
        self.opt_model.load_state_dict(sd["opt_model"])
        self.opt_l0.load_state_dict(sd["opt_l0"])
        self.steps = int(sd["steps"])


def run_stage(model: CLIP, target_sparsity: float, batches, args, stage_idx: int):
    """Distill with pruning, then fuse: returns the pruned model (None when
    `--stop-after` ends the run)."""
    device = model.logit_scale.device
    trainer = L0Distill(model, lr=args.lr, l0_lr=args.l0_lr,
                        target_sparsity=target_sparsity,
                        sparsity_warmup=args.sparsity_warmup,
                        contrastive_weight=args.contrastive_weight,
                        l0_init_mean=args.l0_init_mean, prune_text=args.prune_text)
    gen = torch.Generator(device).manual_seed(args.seed + stage_idx)
    ckpt = os.path.join(args.out, f"mid_stage_{stage_idx}.pt") if args.save_every else None
    start = 0
    if ckpt and os.path.exists(ckpt):
        state = torch.load(ckpt, map_location=device, weights_only=True)
        trainer.load_state_dict(state)
        gen.set_state(state["generator"])
        start = trainer.steps
        print(f"  stage {stage_idx}: resumed mid-stage at step {start}", flush=True)
    loss = sv = torch.tensor(float("nan"))
    for i in range(start, args.steps):
        images, text = batches[i % len(batches)]
        loss, sparsity = trainer.step(images, text, generator=gen)
        sv = sparsity["v"]
        if ckpt and (i + 1) % args.save_every == 0:
            torch.save({**trainer.state_dict(), "generator": gen.get_state()}, ckpt)
        if args.stop_after and (i + 1) >= args.stop_after:
            print(f"  stage {stage_idx}: --stop-after {args.stop_after} (simulated kill)",
                  flush=True)
            return None
    if ckpt and os.path.exists(ckpt):
        os.remove(ckpt)
    print(f"  stage {stage_idx}: final loss {float(loss):.3f} vision sparsity "
          f"{float(sv):.3f}", flush=True)
    masks = trainer.masks()
    before = n_params(model.state_dict())
    pruned, sd = prune_clip(model.state_dict(), model.cfg, masks["v"], masks.get("t"),
                            model.quick_gelu, dtype=model.dtype, device=device)
    after = n_params(sd)
    print(f"  => fuse MASK: {before} -> {after} params ({after / before:.2%})", flush=True)
    return pruned


def run_stage_manual(model: CLIP, target_sparsity: float) -> CLIP:
    """Manual inheritance: widths shrunk by (1 - sparsity) to multiples of
    64, depths rounded, the teacher's weights front-sliced into them."""
    keep = 1.0 - target_sparsity
    cfg = model.cfg

    def r64(x):
        return max(64, int(round(x * keep / 64)) * 64)

    new_cfg = dataclasses.replace(
        cfg, vision_width=r64(cfg.vision_width), text_width=r64(cfg.text_width),
        vision_layers=max(1, int(round(cfg.vision_layers * keep))),
        text_layers=max(1, int(round(cfg.text_layers * keep))))
    student = CLIP(new_cfg, model.quick_gelu, dtype=model.dtype,
                   device=model.logit_scale.device)
    student.load_state_dict(weight_inherit(student.state_dict(), model.state_dict()))
    return student


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    ap.add_argument("--synthetic", action="store_true",
                    help="synthetic image-text pairs (the only data this CLI takes)")
    ap.add_argument("--sparsities", type=float, nargs="+", default=[0.25, 0.333])
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--image-size", type=int, default=64)
    ap.add_argument("--vision-width", type=int, default=128)
    ap.add_argument("--vision-layers", type=int, default=2)
    ap.add_argument("--text-width", type=int, default=128)
    ap.add_argument("--text-layers", type=int, default=2)
    ap.add_argument("--context", type=int, default=16)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--l0-lr", type=float, default=0.1,
                    help="learning rate of the hard-concrete gates and the lagrangian "
                         "multipliers")
    ap.add_argument("--l0-init-mean", type=float, default=10.0,
                    help="initial gate log-alpha (the reference's 10 keeps everything; "
                         "lower it for short runs so the lagrangian can reach the target)")
    ap.add_argument("--sparsity-warmup", type=int, default=2)
    ap.add_argument("--contrastive-weight", type=float, default=1.0)
    ap.add_argument("--prune-text", action="store_true", default=True)
    ap.add_argument("--no-prune-text", dest="prune_text", action="store_false")
    ap.add_argument("--manual-inherit", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--save-every", type=int, default=0,
                    help="mid-stage checkpoint every N steps (0: off); a restarted run "
                         "resumes from it")
    ap.add_argument("--stop-after", type=int, default=0,
                    help="end the run after N steps of the current stage (a kill)")
    ap.add_argument("--out", default="tinyclip_stages")
    args = ap.parse_args(argv)
    if args.cpu:
        args.device = "cpu"
    if not args.synthetic:
        ap.error("only --synthetic pairs are ported (no image-text shards in the repository)")
    return args


def main(argv=None):
    """Runs the stages; returns the report (None after --stop-after)."""
    from cream_tpu_torch.zoo.load import seeded_state_dict
    args = parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("tinyclip_pipeline runs on a CUDA device (none is available); "
                           "pass --device cpu for the CPU")
    cfg = CLIPConfig(embed_dim=64, vision_width=args.vision_width,
                     vision_layers=args.vision_layers, vision_patch=16,
                     image_size=args.image_size, text_width=args.text_width,
                     text_layers=args.text_layers, text_heads=max(2, args.text_width // 64),
                     context_length=args.context)
    model = CLIP(cfg, device=args.device)
    model.load_state_dict(seeded_state_dict(model, args.seed))
    batches = [(i.to(args.device), t.to(args.device)) for i, t in synthetic_pairs(
        args.batch_size, args.image_size, args.context, max(2, args.steps // 2), args.seed)]

    os.makedirs(args.out, exist_ok=True)
    report = [{"stage": "base", "params": n_params(model.state_dict()),
               "vision_width": cfg.vision_width}]
    for si, sp in enumerate(args.sparsities):
        print(f"stage {si}: target sparsity {sp}", flush=True)
        if args.manual_inherit:
            model = run_stage_manual(model, sp)
        else:
            model = run_stage(model, sp, batches, args, si)
            if model is None:
                return None
        sd = model.state_dict()
        report.append({"stage": si, "target_sparsity": sp, "params": n_params(sd),
                       "vision_width": model.cfg.vision_width,
                       "text_width": model.cfg.text_width})
        torch.save(sd, os.path.join(args.out, f"stage_{si}.pt"))

    # the final model still encodes, and the pair similarity is finite
    images, text = batches[0]
    with torch.no_grad():
        img, txt, _ = model(images, text)
    sim = float((img * txt).sum(-1).mean())
    if not np.isfinite(sim):
        raise RuntimeError(f"the final model's pair similarity is {sim}")
    report.append({"final_pair_similarity": sim})
    with open(os.path.join(args.out, "report.json"), "w") as fh:
        json.dump(report, fh, indent=2)
    print(f"wrote {args.out}/report.json: "
          f"{[r.get('params') for r in report if 'params' in r]} params")
    return report


if __name__ == "__main__":
    main()
