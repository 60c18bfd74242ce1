"""Single-image top-5 inference.

    python -m cream_tpu_torch.cli.inference --image cat.jpg \
        --torch-ckpt tiny_vit_21m_22kto1k_distill.pth model.name=tiny_vit_21m_224

Without --torch-ckpt the model gets seeded random weights
(`zoo.load.seeded_state_dict` with `train.seed`). The image is decoded by
`data.image_io.read_rgb` (BMP without Pillow) and resized and cropped as the
eval loader does.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from cream_tpu_torch.core.config import Config


def predict(model: torch.nn.Module, images: torch.Tensor) -> torch.Tensor:
    """NHWC images -> float32 logits, on the model's device and in its compute
    dtype, under torch.inference_mode()."""
    device = next(model.parameters()).device
    with torch.inference_mode():
        return model(images.to(device, model.dtype)).float()


def main(argv=None):
    from cream_tpu_torch.data.image_io import read_rgb
    from cream_tpu_torch.data.transforms import (eval_preprocess_config,
                                                 preprocess_pil)
    from cream_tpu_torch.models import create_model
    from cream_tpu_torch.zoo.load import load_pth, seeded_state_dict

    ap = argparse.ArgumentParser()
    ap.add_argument("--image", required=True)
    ap.add_argument("--cfg", default=None)
    ap.add_argument("--torch-ckpt", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("opts", nargs="*")
    args = ap.parse_args(argv)
    cfg = Config.from_yaml(args.cfg, args.opts)

    model = create_model(cfg.model.name, num_classes=cfg.model.num_classes,
                         device=args.device, dtype=getattr(torch, cfg.model.dtype),
                         **cfg.model.extra)
    sd = (load_pth(args.torch_ckpt) if args.torch_ckpt
          else seeded_state_dict(model, cfg.train.seed))
    model.load_state_dict(sd)

    pp = eval_preprocess_config(cfg.data.img_size, crop=cfg.data.crop)
    img = preprocess_pil(read_rgb(args.image), pp)
    logits = predict(model, torch.from_numpy(img)[None])
    probs = torch.softmax(logits, -1)[0].cpu()
    top5 = np.asarray(torch.topk(probs, 5).indices)
    for rank, c in enumerate(top5):
        print(f"top{rank + 1}: class {int(c)}  p={float(probs[c]):.4f}")
    return top5


if __name__ == "__main__":
    main()
