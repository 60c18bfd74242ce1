"""Throughput harness: warmup, then images/s timed with CUDA events.

    python -m cream_tpu_torch.cli.speed_test --models tiny_vit_21m_224 \
        --batch 256 --img-size 224
    python -m cream_tpu_torch.cli.speed_test --train     # train steps/s
    python -m cream_tpu_torch.cli.speed_test --models efficientvit_m5 \
        --batch 512 attn_kernel=plain                    # model keyword arguments
    python -m cream_tpu_torch.cli.speed_test --train --models efficientvit_m5 \
        --batch 512 dw_kernel=fused                      # or wgrad, library
    python -m cream_tpu_torch.cli.speed_test mbconv_kernel=true pin_layouts=true
    python -m cream_tpu_torch.cli.speed_test --models tiny_vit_21m_384 --batch 64
    python -m cream_tpu_torch.cli.speed_test [--train] --models s3_tiny --batch 128
    python -m cream_tpu_torch.cli.speed_test --models tinyclip_vit_39m_16_text_19m \
        clip_resnet50 --batch 256                        # CLIP: image-text pairs/s
    python -m cream_tpu_torch.cli.speed_test --train \
        --models tinyclip_vit_39m_16_text_19m [remat=true]  # TinyCLIP's L0 distill step
    python -m cream_tpu_torch.cli.speed_test [--train] \
        --models deit_small_patch16_224_ctx_product_50_shared_k \
        mini_deit_small_patch16_224 drop_path_rate=0.1   # DeiT-S iRPE-K, Mini-DeiT-S
    python -m cream_tpu_torch.cli.speed_test [--train] --models \
        autoformer_supernet_tiny cream_supernet --batch 128 config=largest  # smallest, seed:N
    python -m cream_tpu_torch.cli.speed_test --models cream_604 cream_481 \
        --batch 256 [dw_kernel=fused]                    # Cream's released childnets
    python -m cream_tpu_torch.cli.speed_test [--train] --models darts_search_cifar \
        nasbench201_search --batch 64 [dw_kernel=fused]  # DARTS / NAS-Bench-201 search nets
    python -m cream_tpu_torch.cli.speed_test [--train] --models \
        cdarts_retrain_imagenet nasbench201_infer        # discrete nets of an example genotype
    python -m cream_tpu_torch.cli.speed_test [--train | --decode] --models \
        retinanet_efficientvit_m4 mask_rcnn_efficientvit_m4 --batch 16 --img-size 512
    python -m cream_tpu_torch.cli.speed_test [--train | --decode] --models detr_resnet50 \
        --batch 16 --img-size 512 enc_rpe2d=rpe-2.0-product-ctx-1-k aux_loss=true
    python -m cream_tpu_torch.cli.speed_test [--train] --models cydas_seg --batch 12 \
        [dw_kernel=fused]                                # eval 1024x2048, train crop 769

`--train` times full train steps (forward, backward, AdamW update) as the
JAX package's `bench_train_step` does: `adamw(1e-3, weight_decay=0.05)` on
every param with no clipping, random images and int labels, the variant's
drop path, bf16 compute with fp32 params.

A two-tower CLIP model is timed as pairs (`pair_throughput`): NHWC images
and (B, 77) token ids drawn in [0, 49408) from a seeded generator, as the
JAX package's `bench_clip_pair` draws them (over the model's vocabulary), through both towers, and each
iteration consumes both towers' features (their (B, B) similarity
matrix), so the number is pairs/s of the whole model. With `--train` a
two-tower ViT CLIP is timed through TinyCLIP's L0 distillation step
(`tinyclip_train_throughput`, the JAX package's `bench_tinyclip_train`).

A supernet (`autoformer_supernet_*`, `cream_supernet`) is timed at the
fixed config its `config=` option names (`smallest`, `largest`, `seed:N`);
with `--train` through its own step (`nas.supernet_engine.
make_supernet_train_step`, `nas.cream.make_cream_train_step` without KD),
which gives the params off that path zero grads.

A DARTS or NAS-Bench-201 search network (`darts_search_cifar`,
`nasbench201_search`) runs at seeded alphas (`search_alphas`); with
`--train` through its own step, the searcher's weight step
(`nas.cdarts.make_weight_step`). A discrete network built from a genotype
(`cdarts_retrain_*`, `darts_augment_cifar`, `nasbench201_infer`) takes
`models.darts.EXAMPLE_GENOTYPE` (one a group) or
`models.nasbench201.EXAMPLE_ARCH` unless a genotype is given.

A detector (`retinanet_*`, `mask_rcnn_*`; `--img-size` is its canvas, 512
by default) is timed on `detector_batch` (images and the CLIs' synthetic
targets): its eval forward (`detector_forward_fn`; Mask R-CNN's includes
its proposals, whose NMS syncs with the host), with `--decode` the decode
too, with `--train` the CLIs' step (`detector_train_step_fn`).

A DETR (`detr_*`; `--img-size` its canvas, 512 by default) is a detector
too: its batch carries a seeded pixel mask an image (`detr_batch`), the
decode is `train.detection.post_process`, and its train step is the CLI's
(one forward, the host's Hungarian matchings of the final and auxiliary
outputs, AdamW 1e-4 after clipping at 0.1).

A segmenter (`cydas_seg`) is timed on N(0, 1) images and blocky labels
(`seg_batch`): its eval forward at the whole Cityscapes frame, 1024x2048,
and with `--train` the CLI's step (three OHEM losses, SGD) at its 769 crop;
`--img-size` makes both square.

`--img-size` defaults to each model's own (384 for tiny_vit_21m_384).
Weights are seeded random (speed does not depend on them). Each result is
printed as one JSON line beside the card's name and power limit. There is no
CPU timing: a run without a CUDA device fails.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch


# registered detectors: `--img-size` is their canvas
DETECTOR_PREFIXES = ("retinanet_", "mask_rcnn_", "detr_")
# a segmenter's eval input (a whole Cityscapes frame) and train crop
SEG_EVAL_HW, SEG_CROP = (1024, 2048), 769


def card_info() -> str:
    """`name, power.limit` of the current card as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()
    return out[torch.cuda.current_device()].strip()


def throughput(model: torch.nn.Module, batch: int, img_size: int,
               dtype: torch.dtype = torch.bfloat16, n_iters: int = 20,
               warmup: int = 3) -> float:
    """Forward images/s of `model` on its CUDA device: `warmup` untimed
    forwards, then `n_iters` forwards between two CUDA events, under
    torch.inference_mode()."""
    device = next(model.parameters()).device
    if device.type != "cuda":
        raise RuntimeError(f"throughput is measured on a CUDA device, "
                           f"the model is on {device}")
    gen = torch.Generator(device).manual_seed(0)
    x = torch.randn(batch, img_size, img_size, 3, generator=gen,
                    device=device).to(dtype)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    forward = forward_fn(model)
    with torch.inference_mode():
        for _ in range(warmup):
            forward(x)
        start.record()
        for _ in range(n_iters):
            forward(x)
        end.record()
        end.synchronize()
    return batch * n_iters / (start.elapsed_time(end) / 1e3)


def search_alphas(model: torch.nn.Module) -> dict | None:
    """Seeded alphas on the model's device for a DARTS or NAS-Bench-201
    search network (`init_alphas` / `init_alphas_201` from seed 0), else
    None."""
    from cream_tpu_torch.models import darts, nasbench201
    device = next(model.parameters()).device
    gen = torch.Generator(device).manual_seed(0)
    if isinstance(model, darts.SearchCNN):
        return darts.init_alphas(gen, model.n_nodes, device)
    if isinstance(model, nasbench201.TinyNetwork201):
        return nasbench201.init_alphas_201(gen, device=device)
    return None


def forward_fn(model: torch.nn.Module):
    """`model` as a function of the images: a search network at its
    `search_alphas`."""
    alphas = search_alphas(model)
    if alphas is None:
        return model
    return lambda x: model(x, alphas["normal"], alphas["reduce"])


def genotype_kwargs(name: str, kw: dict) -> dict:
    """The example genotype for a registered network built from one, where
    `kw` gives none."""
    from cream_tpu_torch.models import darts, nasbench201
    from cream_tpu_torch.models.registry import accepts
    if accepts(name, "genotypes") and "genotypes" not in kw:
        return {"genotypes": [darts.EXAMPLE_GENOTYPE] * 3}
    if accepts(name, "genotype") and "genotype" not in kw:
        return {"genotype": nasbench201.EXAMPLE_ARCH if name.startswith("nasbench201")
                else darts.EXAMPLE_GENOTYPE}
    return {}


def is_two_tower(model: torch.nn.Module) -> bool:
    return hasattr(model, "encode_image") and hasattr(model, "encode_text")


def pair_inputs(model: torch.nn.Module, batch: int, dtype: torch.dtype = torch.bfloat16,
                seed: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """A CLIP pair batch on the model's CUDA device: (B, S, S, 3) normal
    images in `dtype` and (B, context_length) token ids drawn over the
    vocabulary ([0, 49408) for every registered CLIP)."""
    device = next(model.parameters()).device
    if device.type != "cuda":
        raise RuntimeError(f"throughput is measured on a CUDA device, "
                           f"the model is on {device}")
    gen = torch.Generator(device).manual_seed(seed)
    s = model.img_size
    images = torch.randn(batch, s, s, 3, generator=gen, device=device).to(dtype)
    text = torch.randint(0, model.token_embedding.num_embeddings,
                         (batch, model.context_length), generator=gen, device=device)
    return images, text


def pair_step(model: torch.nn.Module, images: torch.Tensor, text: torch.Tensor
              ) -> torch.Tensor:
    """One pair forward whose result reads both towers' features: the
    scaled (B, B) image-text similarity."""
    img, txt, scale = model(images, text)
    return scale * img @ txt.T


def pair_throughput(model: torch.nn.Module, batch: int, dtype: torch.dtype = torch.bfloat16,
                    n_iters: int = 20, warmup: int = 3) -> float:
    """Image-text pairs/s of a two-tower CLIP `model` on its CUDA device:
    `warmup` untimed pair forwards, then `n_iters` between two CUDA events,
    under torch.inference_mode(); each forward's similarity matrix is
    summed into a value read after the last, so both towers' outputs are
    consumed."""
    images, text = pair_inputs(model, batch, dtype)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.inference_mode():
        for _ in range(warmup):
            pair_step(model, images, text)
        total = torch.zeros((), device=images.device)
        start.record()
        for _ in range(n_iters):
            total += pair_step(model, images, text).float().sum()
        end.record()
        end.synchronize()
    if not torch.isfinite(total):
        raise RuntimeError("the pair forwards gave a non-finite similarity")
    return batch * n_iters / (start.elapsed_time(end) / 1e3)


def train_step_fn(model: torch.nn.Module, batch: int, img_size: int,
                  dtype: torch.dtype = torch.bfloat16, num_classes: int | None = None):
    """A zero-argument function that runs one train step of `model` (the
    JAX package's `bench_train_step`: `make_train_step` with int labels,
    adamw(1e-3, weight_decay=0.05) on every param, no clipping) on one
    random batch on the model's CUDA device; labels below `num_classes`
    (default: the model's `num_classes`, else 1000)."""
    from cream_tpu_torch.train import TrainState, make_train_step
    from cream_tpu_torch.train.optim import make_adamw

    device = next(model.parameters()).device
    if device.type != "cuda":
        raise RuntimeError(f"throughput is measured on a CUDA device, "
                           f"the model is on {device}")
    gen = torch.Generator(device).manual_seed(1)
    x = torch.randn(batch, img_size, img_size, 3, generator=gen,
                    device=device).to(dtype)
    num_classes = num_classes or getattr(model, "num_classes", 1000)
    labels = torch.randint(0, num_classes, (batch,), generator=gen, device=device)
    state = TrainState(model, make_adamw(1e-3, weight_decay=0.05, clip_grad=None))
    data = {"image": x, "label": labels}
    step = supernet_step(model)
    if step is None:
        step = make_train_step()
    return lambda: step(state, data, 3)


def supernet_step(model: torch.nn.Module):
    """A supernet's own train step at the config fixed at its build, as
    `make_train_step`'s step(state, batch, seed) (the params off that path
    get zero grads: `train.steps.supernet_grads`); a search network's weight
    step at its `search_alphas` with the state's optimizer; or None for a
    fixed model."""
    from cream_tpu_torch.models.autoformer import AutoFormerSuper
    from cream_tpu_torch.models.cream import CreamSupernet
    alphas = search_alphas(model)
    if alphas is not None:
        from cream_tpu_torch.nas.cdarts import make_weight_step
        return lambda state, batch, seed: (state, make_weight_step(model, state.tx)(alphas,
                                                                                    batch))
    if isinstance(model, AutoFormerSuper):
        from cream_tpu_torch.nas.supernet_engine import make_supernet_train_step
        af_step = make_supernet_train_step()
        return lambda state, batch, seed: af_step(state, batch, model.config, seed)
    if isinstance(model, CreamSupernet):
        from cream_tpu_torch.nas.cream import make_cream_train_step
        cream_step = make_cream_train_step()
        return lambda state, batch, seed: cream_step(state, batch, model.config, None, 0.0,
                                                     False)
    return None


def train_throughput(model: torch.nn.Module, batch: int, img_size: int,
                     dtype: torch.dtype = torch.bfloat16, n_iters: int = 10,
                     warmup: int = 3) -> float:
    """Train images/s of `model` on its CUDA device: `warmup` untimed
    steps of `train_step_fn`, then `n_iters` between two CUDA events."""
    return timed_images_per_s(train_step_fn(model, batch, img_size, dtype), batch, n_iters,
                              warmup)


def tinyclip_train_step_fn(model: torch.nn.Module, batch: int, seed: int = 0):
    """(the trainer, a zero-argument function that runs one step): TinyCLIP's
    L0 distillation step (`cli.tinyclip_pipeline.L0Distill`) on `model`'s
    CUDA device as the JAX package's `bench_tinyclip_train` sets it up:
    gates on both towers (hidden, heads, intermediate) from log-alpha 10,
    target sparsity 0.25 over a 1,000-step warmup, Adam 1e-4 on the
    weights and 1e-2 on the gates and multipliers, the contrastive loss at
    weight 1, a frozen teacher copy; one batch of `pair_inputs` in the
    model's compute dtype, the masks' noise from a seeded generator."""
    from cream_tpu_torch.cli.tinyclip_pipeline import L0Distill
    from cream_tpu_torch.models.clip import CLIP
    if not isinstance(model, CLIP):
        raise TypeError(f"TinyCLIP's train step takes a two-tower ViT CLIP, not "
                        f"{type(model).__name__}")
    images, text = pair_inputs(model, batch, model.dtype, seed)
    trainer = L0Distill(model, lr=1e-4, l0_lr=1e-2, target_sparsity=0.25,
                        sparsity_warmup=1000, contrastive_weight=1.0, l0_init_mean=10.0)
    gen = torch.Generator(images.device).manual_seed(seed + 3)
    return trainer, lambda: trainer.step(images, text, generator=gen)


def tinyclip_train_throughput(model: torch.nn.Module, batch: int = 256, n_iters: int = 10,
                              warmup: int = 3) -> dict:
    """Train pairs/s of TinyCLIP's L0 distillation step on `model` (a
    two-tower ViT CLIP on a CUDA device; `tinyclip_train_step_fn`):
    `warmup` untimed steps, then `n_iters` between two CUDA events; the
    peak device memory over the timed steps (weights, teacher, gates and
    both optimizers' slots included); the first step's loss and the
    losses of all steps."""
    _, run = tinyclip_train_step_fn(model, batch)
    losses = [run()[0] for _ in range(warmup)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n_iters):
        losses.append(run()[0])
    end.record()
    end.synchronize()
    losses = [float(v) for v in losses]
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"TinyCLIP train steps gave a non-finite loss: {losses}")
    ms = start.elapsed_time(end) / n_iters
    return {"pairs_per_s": batch / ms * 1e3, "ms_per_step": ms,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "first_loss": losses[0], "losses": losses}


def is_detector(model: torch.nn.Module) -> bool:
    from cream_tpu_torch.models.detr import DETR
    from cream_tpu_torch.models.mask_rcnn import MaskRCNN
    from cream_tpu_torch.models.retinanet import RetinaNet
    return isinstance(model, (RetinaNet, MaskRCNN, DETR))


def is_segmenter(model: torch.nn.Module) -> bool:
    from cream_tpu_torch.models.cydas_seg import CyDASSeg
    return isinstance(model, CyDASSeg)


def _cuda_device(model: torch.nn.Module) -> torch.device:
    device = next(model.parameters()).device
    if device.type != "cuda":
        raise RuntimeError(f"throughput is measured on a CUDA device, "
                           f"the model is on {device}")
    return device


def detr_batch(model: torch.nn.Module, batch: int, dtype: torch.dtype = torch.bfloat16,
               seed: int = 0, max_boxes: int = 32) -> dict:
    """A DETR batch on the model's CUDA device: N(0, 1)
    images at the model's canvas in `dtype`, each with a pixel mask that
    pads a seeded right and bottom margin (the unpadded part 50-100% of each
    side, as a resized COCO image on a static canvas), and the DETR CLI's
    synthetic targets (normalized cxcywh boxes, labels, valid), all from
    default_rng(seed)."""
    from cream_tpu_torch.cli.train_detr import synthetic_targets
    device = _cuda_device(model)
    rng = np.random.default_rng(seed)
    c = model.canvas
    images = rng.standard_normal((batch, c, c, 3)).astype(np.float32)
    keep = rng.integers(c // 2, c + 1, (batch, 2))
    mask = np.ones((batch, c, c), bool)
    for i, (h, w) in enumerate(keep):
        mask[i, :h, :w] = False
    images[mask] = 0.0
    boxes, labels, valid = synthetic_targets(rng, batch, max_boxes, model.num_classes)
    out = {"image": torch.from_numpy(images).to(device, dtype),
           "pad_mask": torch.from_numpy(mask).to(device)}
    out.update({k: torch.from_numpy(v).to(device) for k, v in
                (("boxes", boxes), ("labels", labels), ("valid", valid))})
    return out


def detector_batch(model: torch.nn.Module, batch: int, dtype: torch.dtype = torch.bfloat16,
                   seed: int = 0, max_boxes: int = 32) -> dict:
    """A detection batch on the model's CUDA device: N(0, 1) images at its
    canvas in `dtype`, and the CLIs' synthetic targets (boxes, labels,
    valid; instance masks for Mask R-CNN) from default_rng(seed); a DETR's
    is `detr_batch`."""
    from cream_tpu_torch.cli.train_mask_rcnn import synthetic_targets
    from cream_tpu_torch.models.detr import DETR
    from cream_tpu_torch.models.mask_rcnn import MaskRCNN
    if isinstance(model, DETR):
        return detr_batch(model, batch, dtype, seed, max_boxes)
    device = _cuda_device(model)
    rng = np.random.default_rng(seed)
    c = model.canvas
    tgt = synthetic_targets(rng, batch, c, max_boxes, model.num_classes)
    if not isinstance(model, MaskRCNN):
        del tgt["masks"]
    gen = torch.Generator(device).manual_seed(seed)
    out = {k: torch.as_tensor(v, device=device) for k, v in tgt.items()}
    out["image"] = torch.randn(batch, c, c, 3, generator=gen, device=device).to(dtype)
    return out


def detector_forward_fn(model: torch.nn.Module, images: torch.Tensor, decode: bool = False,
                        pad_mask: torch.Tensor | None = None):
    """A zero-argument eval forward of a detector under inference_mode.
    RetinaNet: the head's outputs, then (`decode`) `retinanet_decode` with
    its host NMS. Mask R-CNN: features, RPN, proposals (their NMS syncs
    with the host), the box head; then (`decode`) the second-stage decode
    and the mask head on its detections (`cli.train_mask_rcnn.infer`).
    DETR: the outputs on the images and `pad_mask`, then (`decode`)
    `post_process` to canvas pixels."""
    from cream_tpu_torch.cli.train_mask_rcnn import infer
    from cream_tpu_torch.models.detr import DETR
    from cream_tpu_torch.models.mask_rcnn import (MaskRCNN, mask_rcnn_anchor_levels,
                                                  mask_rcnn_anchors, rois_flat, rpn_proposals)
    from cream_tpu_torch.models.retinanet import (anchors_per_level, retina_anchors,
                                                  retinanet_decode)
    from cream_tpu_torch.train.detection import post_process
    device, c = images.device, model.canvas
    if isinstance(model, DETR):
        sizes = torch.full((images.shape[0], 2), float(c), device=device)

        def run():
            with torch.inference_mode():
                out = model(images, pad_mask)
                return post_process({k: out[k].float() for k in ("pred_logits", "pred_boxes")},
                                    sizes) if decode else out
        return run
    if isinstance(model, MaskRCNN):
        anchors = torch.from_numpy(mask_rcnn_anchors(c)).to(device)
        levels = mask_rcnn_anchor_levels(c)

        def run():
            with torch.inference_mode():
                if decode:
                    return infer(model, images, anchors, levels, 256, 100)
                feats = model.features(images)
                props, _ = rpn_proposals(*model.rpn(feats), anchors, levels, c)
                return model.roi_bbox(feats, rois_flat(props))
        return run
    anchors = torch.from_numpy(retina_anchors(c)).to(device)
    levels = anchors_per_level(c)

    def run():
        with torch.inference_mode():
            out = model(images)
            return retinanet_decode(*out, anchors, levels) if decode else out
    return run


def detector_train_step_fn(model: torch.nn.Module, batch: int,
                           dtype: torch.dtype = torch.bfloat16, seed: int = 0):
    """(the step's state, a zero-argument function that runs one train step
    of a detector on one `detector_batch` and returns (loss, losses)): the
    CLIs' step, AdamW(1e-4, wd 0.05, no decay on the bias tables); Mask
    R-CNN at the CLI's sampler sizes (256 RPN samples, 128 rois, 256
    proposals), its priorities drawn from a generator seeded `seed + 1`.
    DETR: its CLI's step (`cli.train_detr`), AdamW(1e-4, wd 1e-4) after
    clipping at 0.1."""
    from cream_tpu_torch.cli.train_detr import detr_adamw, detr_step_loss
    from cream_tpu_torch.cli.train_retinanet import detection_adamw, retinanet_step_loss
    from cream_tpu_torch.models.detr import DETR
    from cream_tpu_torch.models.mask_rcnn import (MaskRCNN, mask_rcnn_anchor_levels,
                                                  mask_rcnn_anchors, mask_rcnn_losses,
                                                  sampler_uniforms)
    from cream_tpu_torch.models.retinanet import retina_anchors
    from cream_tpu_torch.train.state import TrainState
    from cream_tpu_torch.train.steps import make_loss_step
    b = detector_batch(model, batch, dtype, seed)
    device, c = b["image"].device, model.canvas
    if isinstance(model, DETR):
        state = TrainState(model, detr_adamw())
        step = make_loss_step(detr_step_loss(model.num_classes))
        return state, lambda: step(state, b)[1:]
    state = TrainState(model, detection_adamw(model, 1e-4))
    if not isinstance(model, MaskRCNN):
        step = make_loss_step(retinanet_step_loss(
            torch.from_numpy(retina_anchors(c)).to(device), model.num_classes))
        return state, lambda: step(state, b)[1:]
    anchors = torch.from_numpy(mask_rcnn_anchors(c)).to(device)
    levels = mask_rcnn_anchor_levels(c)
    gen = torch.Generator(device).manual_seed(seed + 1)
    step = make_loss_step(lambda m, u_rpn, u_rcnn: mask_rcnn_losses(
        m, b["image"], b["boxes"], b["labels"], b["valid"], b["masks"], anchors, levels,
        u_rpn, u_rcnn))

    def run():
        u = sampler_uniforms(gen, batch, anchors.shape[0], b["boxes"].shape[1] + 256, device)
        return step(state, *u)[1:]
    return state, run


def timed_images_per_s(run, batch: int, n_iters: int, warmup: int) -> float:
    """`batch` * `n_iters` / the seconds between two CUDA events around
    `n_iters` calls of `run`, after `warmup` untimed ones."""
    for _ in range(warmup):
        run()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n_iters):
        run()
    end.record()
    end.synchronize()
    return batch * n_iters / (start.elapsed_time(end) / 1e3)


def detector_throughput(model: torch.nn.Module, batch: int, dtype: torch.dtype = torch.bfloat16,
                        decode: bool = False, n_iters: int = 10, warmup: int = 3) -> float:
    """Eval images/s of a detector (`detector_forward_fn`), the host's NMS
    included where the path has one."""
    b = detector_batch(model, batch, dtype)
    run = detector_forward_fn(model, b["image"], decode, b.get("pad_mask"))
    return timed_images_per_s(run, batch, n_iters, warmup)


def seg_batch(model: torch.nn.Module, batch: int, hw: tuple[int, int],
              dtype: torch.dtype = torch.bfloat16, seed: int = 0) -> dict:
    """A segmentation batch on the model's CUDA device:
    `data.segmentation.synthetic_seg_batches`' first (N(0, 1) images in
    `dtype`, blocky labels, the first two rows ignored)."""
    from cream_tpu_torch.data.segmentation import synthetic_seg_batches
    device = _cuda_device(model)
    b = next(synthetic_seg_batches(batch, hw, model.num_classes, 1, seed))
    return {"image": torch.from_numpy(b["image"]).to(device, dtype),
            "label": torch.from_numpy(b["label"]).to(device)}


def seg_forward_fn(model: torch.nn.Module, images: torch.Tensor):
    """A zero-argument eval forward of a segmenter under inference_mode,
    ending in the per-pixel argmax."""
    def run():
        with torch.inference_mode():
            return model(images).argmax(-1)
    return run


def seg_train_step_fn(model: torch.nn.Module, batch: int, hw: tuple[int, int] = (SEG_CROP,) * 2,
                      dtype: torch.dtype = torch.bfloat16, seed: int = 0):
    """(the step's state, a zero-argument function that runs one train step
    of a segmenter on one `seg_batch` and returns (loss, metrics)): the
    train_seg CLI's step, OHEM with min_kept = B·H·W // 16 on the three
    heads, SGD(0.01, momentum 0.9) after decay 5e-4."""
    from cream_tpu_torch.cli.train_seg import seg_sgd, seg_step_loss
    from cream_tpu_torch.train.state import TrainState
    from cream_tpu_torch.train.steps import make_loss_step
    b = seg_batch(model, batch, hw, dtype, seed)
    state = TrainState(model, seg_sgd(0.01))
    step = make_loss_step(seg_step_loss(batch * hw[0] * hw[1] // 16, model.num_classes))
    return state, lambda: step(state, b)[1:]


def seg_throughput(model: torch.nn.Module, batch: int, hw: tuple[int, int] = SEG_EVAL_HW,
                   dtype: torch.dtype = torch.bfloat16, n_iters: int = 10,
                   warmup: int = 3) -> float:
    """Eval images/s of a segmenter (`seg_forward_fn`)."""
    run = seg_forward_fn(model, seg_batch(model, batch, hw, dtype)["image"])
    return timed_images_per_s(run, batch, n_iters, warmup)


def seg_train_throughput(model: torch.nn.Module, batch: int,
                         hw: tuple[int, int] = (SEG_CROP,) * 2,
                         dtype: torch.dtype = torch.bfloat16, n_iters: int = 10,
                         warmup: int = 3) -> float:
    """Train images/s of a segmenter (`seg_train_step_fn`)."""
    _, run = seg_train_step_fn(model, batch, hw, dtype)
    return timed_images_per_s(run, batch, n_iters, warmup)


def detector_train_throughput(model: torch.nn.Module, batch: int,
                              dtype: torch.dtype = torch.bfloat16, n_iters: int = 10,
                              warmup: int = 3) -> float:
    """Train images/s of a detector (`detector_train_step_fn`)."""
    _, run = detector_train_step_fn(model, batch, dtype)
    return timed_images_per_s(run, batch, n_iters, warmup)


def model_kwargs(opts: list[str]) -> dict:
    """`key=value` words -> keyword arguments for `create_model`, values
    parsed as config overrides are (numbers, booleans, null, else str)."""
    from cream_tpu_torch.core.config import _parse_value
    kw = {}
    for opt in opts:
        key, sep, value = opt.partition("=")
        if not sep:
            raise ValueError(f"model option {opt!r} is not key=value")
        kw[key] = _parse_value(value)
    return kw


def main(argv=None):
    from cream_tpu_torch.models import create_model, list_models
    from cream_tpu_torch.zoo.load import seeded_state_dict

    ap = argparse.ArgumentParser()
    ap.add_argument("--models", nargs="+", default=["tiny_vit_21m_224"])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--img-size", type=int, default=None,
                    help="input size (default: the model's own)")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--train", action="store_true",
                    help="time train steps instead of forwards")
    ap.add_argument("--decode", action="store_true",
                    help="a detector's forward plus its decode (the host's NMS included)")
    ap.add_argument("opts", nargs="*",
                    help="model keyword arguments as key=value (e.g. attn_kernel=plain)")
    args = ap.parse_args(argv)
    dtype = getattr(torch, args.dtype)
    kw = model_kwargs(args.opts)
    results = {}
    for name in args.models:
        if name not in list_models():
            print(f"skip unknown model {name}")
            continue
        size = {} if args.img_size is None or name.startswith("cydas") else {
            "canvas" if name.startswith(DETECTOR_PREFIXES) else "img_size": args.img_size}
        model = create_model(name, device=args.device, dtype=dtype, **size, **kw,
                             **genotype_kwargs(name, kw))
        model.load_state_dict(seeded_state_dict(model, 0))
        pairs = is_two_tower(model)
        if is_segmenter(model):
            hw = None if args.img_size is None else (args.img_size,) * 2
            ips = (seg_train_throughput(model, args.batch, hw or (SEG_CROP,) * 2, dtype,
                                        args.iters) if args.train
                   else seg_throughput(model, args.batch, hw or SEG_EVAL_HW, dtype, args.iters))
        elif is_detector(model):
            ips = (detector_train_throughput(model, args.batch, dtype, args.iters) if args.train
                   else detector_throughput(model, args.batch, dtype, args.decode, args.iters))
        elif pairs and args.train:
            ips = tinyclip_train_throughput(model, args.batch, args.iters)["pairs_per_s"]
        elif args.train:
            ips = train_throughput(model, args.batch, model.img_size, dtype,
                                   args.iters)
        elif pairs:
            ips = pair_throughput(model, args.batch, dtype, args.iters)
        else:
            ips = throughput(model, args.batch, model.img_size, dtype, args.iters)
        results[name] = ips
        print(json.dumps({"model": name, "pairs_per_s" if pairs else "img_per_s": ips,
                          "batch": args.batch,
                          "img_size": getattr(model, "img_size", args.img_size),
                          "dtype": args.dtype, "train": args.train, "decode": args.decode,
                          **kw,
                          "card": card_info()}))
    return results


if __name__ == "__main__":
    main()
