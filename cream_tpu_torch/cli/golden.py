"""Golden-activation parity harness for released checkpoints: counterpart
of `cream_tpu/cli/golden.py`.

On a machine with the released .pth files (PARITY.md's protocol):

  1. `--dump ours.npz` runs the port's model, with the checkpoint's weights
     loaded through `zoo.load`, on a deterministic input battery (256 seeded
     images; the same bytes as the JAX package's battery on every machine)
     and stores its logits;
  2. the reference repo's PyTorch model, or the JAX package's
     `cream_tpu.cli.golden --dump`, runs on the same battery and file;
  3. `--compare ours.npz theirs.npz` reports max|diff|, top-1 agreement and
     top-5 overlap, and fails below the top-1 agreement tolerance.

    python -m cream_tpu_torch.cli.golden --model tiny_vit_21m_224 \
        --torch-ckpt tiny_vit_21m_22kto1k_distill.pth --dump ours.npz
    python -m cream_tpu_torch.cli.golden --device cpu --model efficientvit_m0 \
        --torch-ckpt efficientvit_m0.pth --n 8 --img 224 --dump ours.npz
    python -m cream_tpu_torch.cli.golden --compare ours.npz theirs.npz

Families are routed as the JAX CLI routes them: a two-tower CLIP dumps its
L2-normalized image features; `cdarts_retrain_*` needs `--cells-json` (the
genotype file the checkpoint was retrained from); `autoformer_supernet_*`
needs `--subnet-yaml` (experiments/subnet/AutoFormer-*.yaml, whose RETRAIN
section picks the released subnet). The forward runs in fp32, in eval mode,
64 images at a time.
"""
from __future__ import annotations

import argparse

import numpy as np


def battery(n: int = 256, img: int = 224, seed: int = 0) -> np.ndarray:
    """Deterministic input battery: seeded uniform images in [0, 1),
    ImageNet-normalized; the same bytes as the JAX package's on every
    machine."""
    rng = np.random.Generator(np.random.PCG64(seed))
    x = rng.random((n, img, img, 3), np.float32)
    mean = np.asarray([0.485, 0.456, 0.406], np.float32)
    std = np.asarray([0.229, 0.224, 0.225], np.float32)
    return (x - mean) / std


def _parse_retrain_yaml(path: str) -> dict:
    """experiments/subnet/AutoFormer-*.yaml RETRAIN -> the reference's
    config dict (evolution.py's decode format)."""
    import yaml
    with open(path) as fh:
        r = yaml.safe_load(fh)["RETRAIN"]
    depth = int(r["DEPTH"])
    return {"layer_num": depth,
            "embed_dim": [int(r["EMBED_DIM"])] * depth
            if not isinstance(r["EMBED_DIM"], list)
            else [int(e) for e in r["EMBED_DIM"]][:depth],
            "num_heads": [int(h) for h in r["NUM_HEADS"]][:depth],
            "mlp_ratio": [float(m) for m in r["MLP_RATIO"]][:depth]}


def dump_ours(model_name: str, ckpt: str, out: str, img: int, n: int,
              cells_json: str | None = None, subnet_yaml: str | None = None,
              device="cuda") -> np.ndarray:
    """The port's model `model_name` with the weights of the released-layout
    `ckpt` on the battery (n images at img x img); writes the JAX CLI's
    .npz (logits, model, img, n) and returns the logits."""
    import torch

    from cream_tpu_torch.models import create_model
    from cream_tpu_torch.zoo.load import load_cdarts_retrain, load_for_model

    device = torch.device(device)
    if model_name.startswith(("tinyclip", "clip")) \
            and not model_name.endswith(("_classifier", "_tower")):
        model = create_model(model_name, device=device)
        model.load_state_dict(load_for_model(model, ckpt))
        fwd = lambda x: model.encode_image(x, normalized=True)
    elif model_name.startswith("cdarts_retrain"):
        if not cells_json:
            raise SystemExit("cdarts_retrain_* needs --cells-json")
        model_type = "imagenet" if model_name.endswith("imagenet") else "cifar"
        model = load_cdarts_retrain(ckpt, cells_json, device=device, model_type=model_type,
                                    init_channels=48 if model_type == "imagenet" else 36)
        fwd = model
    elif model_name.startswith("autoformer_supernet"):
        if not subnet_yaml:
            raise SystemExit("autoformer_supernet_* needs --subnet-yaml")
        config = _parse_retrain_yaml(subnet_yaml)
        model = create_model(model_name, device=device, img_size=img)
        model.load_state_dict(load_for_model(model, ckpt))
        fwd = lambda x: model(x, config=config)
    else:
        model = create_model(model_name, device=device, img_size=img)
        model.load_state_dict(load_for_model(model, ckpt))
        fwd = model
    x = battery(n, img)
    with torch.inference_mode():
        logits = np.concatenate([fwd(torch.from_numpy(x[i:i + 64]).to(device)).float().cpu()
                                 .numpy() for i in range(0, n, 64)])
    np.savez(out, logits=logits.astype(np.float32), model=model_name, img=img, n=n)
    print(f"wrote {out}: logits {logits.shape}")
    return logits


def compare(a_path: str, b_path: str, top1_tol: float = 0.0) -> dict:
    a = np.load(a_path, allow_pickle=True)
    b = np.load(b_path, allow_pickle=True)
    la, lb = a["logits"], b["logits"]
    if la.shape != lb.shape:
        raise SystemExit(f"logits shapes differ: {la.shape} vs {lb.shape}")
    maxdiff = float(np.abs(la - lb).max())
    agree = float((la.argmax(-1) == lb.argmax(-1)).mean())
    t5a, t5b = np.argsort(-la, -1)[:, :5], np.argsort(-lb, -1)[:, :5]
    overlap = float(np.mean([len(set(r) & set(s)) / 5 for r, s in zip(t5a, t5b)]))
    print(f"max|logit diff| = {maxdiff:.3e}  top1 agreement = {agree:.3f}  "
          f"top5 overlap = {overlap:.3f}")
    if agree < 1.0 - top1_tol:
        raise SystemExit(f"top-1 agreement {agree} below tolerance")
    return {"maxdiff": maxdiff, "top1_agree": agree, "top5_overlap": overlap}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default=None)
    ap.add_argument("--torch-ckpt", default=None)
    ap.add_argument("--img", type=int, default=224)
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--dump", default=None, help="output .npz path")
    ap.add_argument("--cells-json", default=None,
                    help="cdarts_retrain_*: genotype cells .json")
    ap.add_argument("--subnet-yaml", default=None,
                    help="autoformer_supernet_*: released subnet yaml")
    ap.add_argument("--compare", nargs=2, default=None, metavar=("OURS", "THEIRS"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.compare:
        return compare(*args.compare)
    if not (args.model and args.torch_ckpt and args.dump):
        raise SystemExit("need --model + --torch-ckpt + --dump (or --compare)")
    return dump_ours(args.model, args.torch_ckpt, args.dump, args.img, args.n,
                     cells_json=args.cells_json, subnet_yaml=args.subnet_yaml,
                     device=args.device)


if __name__ == "__main__":
    main()
