"""CLIP zero-shot classification CLI: counterpart of
`cream_tpu/cli/zero_shot.py` (TinyCLIP/src/training/zero_shot.py).

    python -m cream_tpu_torch.cli.zero_shot model.name=tinyclip_vit_39m_16_text_19m \
        data.dataset=synthetic data.batch_size=256 \
        --bpe bpe_simple_vocab_16e6.txt.gz [--torch-ckpt TinyCLIP-ViT-39M-16-Text-19M.pt]
    python -m cream_tpu_torch.cli.zero_shot --device cpu model.dtype=float32 \
        model.name=tinyclip_vit_8m_16_text_3m data.dataset=synthetic \
        data.batch_size=4 --bpe merges.txt.gz --classnames names.txt

Builds the zero-shot classifier from the class names (with 1000 classes and
no `--classnames`: OpenAI's 1000 ImageNet names and 80 templates; with
`--classnames`, one name a line, the 8 default templates) and reports
top-1/top-5 over the dataset, beside the tokenizer's host seconds and the
text and image passes' seconds. Weights: `--torch-ckpt` (a TinyCLIP or
OpenAI-CLIP .pth in any historical layout; a pruned TinyCLIP checkpoint
builds its own ragged model), else seeded random weights (`train.seed`),
which check the pipeline and say nothing of accuracy. Data: the val split
of `cli.train.build_dataset` (synthetic or an image folder), resized and
centre-cropped to the model's image size and normalized with CLIP's mean
and std, as the JAX CLI does.
"""
from __future__ import annotations

import argparse

import torch

from cream_tpu_torch.cli.train import build_dataset
from cream_tpu_torch.core.config import Config
from cream_tpu_torch.data.imagenet import eval_loader, prefetch
from cream_tpu_torch.data.tokenizer import get_tokenizer
from cream_tpu_torch.models import create_model
from cream_tpu_torch.models.clip import CLIP_CONFIGS
from cream_tpu_torch.train.zero_shot import (DEFAULT_TEMPLATES, build_zero_shot_classifier,
                                             device_clock, openai_imagenet_constants,
                                             zero_shot_eval)
from cream_tpu_torch.zoo.load import load_for_model, load_pruned_clip, seeded_state_dict


def build_clip(cfg: Config, device: torch.device, dtype: torch.dtype,
               torch_ckpt: str | None) -> torch.nn.Module:
    """The two-tower model of `model.name`: a ViT CLIP from `torch_ckpt`
    takes the checkpoint's own (possibly pruned) geometry, an RN CLIP the
    registered one; without a checkpoint, seeded random weights."""
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    name, extra = cfg.model.name, dict(cfg.model.extra)
    if torch_ckpt and name in CLIP_CONFIGS:
        model, sd = load_pruned_clip(name, torch_ckpt, device=device, dtype=dtype, **extra)
    else:
        model = create_model(name, device=device, dtype=dtype, **extra)
        sd = (load_for_model(model, torch_ckpt) if torch_ckpt
              else seeded_state_dict(model, cfg.train.seed))
    if not hasattr(model, "encode_text"):
        raise ValueError(f"{name} is not a two-tower CLIP model")
    model.load_state_dict(sd)
    return model.eval()


def _num_classes(ds) -> int:
    """The synthetic set's class count; 1,000 for a folder, which carries no
    `num_classes` (as in the JAX CLI)."""
    return getattr(ds, "num_classes", 1000) or 1000


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cfg", default=None)
    ap.add_argument("--bpe", default=None, help="bpe_simple_vocab_16e6.txt.gz")
    ap.add_argument("--torch-ckpt", default=None)
    ap.add_argument("--classnames", default=None,
                    help="file with one class name per line (dataset order)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("opts", nargs="*")
    args = ap.parse_args(argv)
    cfg = Config.from_yaml(args.cfg, args.opts)
    device = torch.device(args.device)
    dtype = getattr(torch, cfg.model.dtype)
    model = build_clip(cfg, device, dtype, args.torch_ckpt)
    ds = build_dataset(cfg, train=False)
    templates = {}
    if args.classnames:
        with open(args.classnames) as fh:
            classnames = [line.strip() for line in fh if line.strip()]
    elif _num_classes(ds) == 1000:
        classnames, templates["templates"] = openai_imagenet_constants()
    else:
        classnames = [f"class {i}" for i in range(_num_classes(ds))]

    tokenizer = get_tokenizer(args.bpe)
    timing = {"image_s": 0.0}

    def encode_text(tokens):
        with torch.inference_mode():
            return model.encode_text(tokens)

    def encode_image(images):
        t0 = device_clock(device)
        with torch.inference_mode():
            feats = model.encode_image(images.to(device, dtype))
        timing["image_s"] += device_clock(device) - t0
        return feats

    classifier = build_zero_shot_classifier(
        encode_text, lambda texts: tokenizer(texts, model.context_length), classnames,
        device=device, stats=timing, **templates)
    batches = ({"image": torch.from_numpy(b["image"]), "label": b["label"]}
               for b in prefetch(eval_loader(ds, cfg.data.batch_size, model.img_size,
                                             crop=True, clip_norm=True,
                                             num_workers=cfg.data.num_workers)))
    res = zero_shot_eval(encode_image, classifier, batches)
    n_prompts = len(classnames) * len(templates.get("templates", DEFAULT_TEMPLATES))
    print(f"zero-shot top1={res['zeroshot_top1']:.3f} top5={res['zeroshot_top5']:.3f} "
          f"n={res['n']}; classifier {tuple(classifier.shape)} from {len(classnames)} "
          f"classes ({n_prompts} prompts): tokenizer "
          f"{timing['tokenize_s']:.3f} s (host), text passes {timing['encode_s']:.3f} s, "
          f"image passes {timing['image_s']:.3f} s")
    return {**res, **timing, "classifier": classifier}


if __name__ == "__main__":
    main()
