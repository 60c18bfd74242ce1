"""Zero-shot classification with CLIP models.

Counterpart of `cream_tpu/train/zero_shot.py` (TinyCLIP/src/training/
zero_shot.py): a classifier from class-name x template prompts (their text
features averaged over the templates and L2-normalized), then top-1/top-5
of image features against it. One card: the prompts go through the text
tower in chunks of `batch_size` classes.
"""
from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import torch

# a high-signal subset of OpenAI's 80 ImageNet prompt templates; the full
# set and the 1000 class names are in data/zero_shot_constants.json
# (`openai_imagenet_constants`)
DEFAULT_TEMPLATES = (
    "a photo of a {}.",
    "a photo of the {}.",
    "a bad photo of a {}.",
    "a photo of many {}.",
    "a close-up photo of a {}.",
    "a black and white photo of a {}.",
    "itap of a {}.",
    "a low resolution photo of a {}.",
)


def openai_imagenet_constants() -> tuple[list, list]:
    """(classnames, templates): OpenAI CLIP's public ImageNet zero-shot set,
    1000 names and 80 prompt templates."""
    path = Path(__file__).resolve().parent.parent / "data" / "zero_shot_constants.json"
    d = json.loads(path.read_text())
    return d["classnames"], d["templates"]


def device_clock(device: torch.device) -> float:
    """The host clock (s) after `device`'s queued work is done."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def build_zero_shot_classifier(encode_text_fn, tokenizer, classnames,
                               templates=DEFAULT_TEMPLATES, batch_size: int = 64,
                               *, device, stats: dict | None = None) -> torch.Tensor:
    """-> (embed_dim, num_classes) classifier on `device`: each class's
    prompt features (`encode_text_fn` gives them L2-normalized) averaged
    over the templates and L2-normalized again, in the features' dtype.
    With `stats`, adds the host seconds of the tokenizer (`tokenize_s`) and
    the seconds of the text passes, synchronized (`encode_s`)."""
    device = torch.device(device)
    weights, tok_s, enc_s = [], 0.0, 0.0
    for i in range(0, len(classnames), batch_size):
        chunk = classnames[i:i + batch_size]
        t0 = time.perf_counter()
        tokens = np.asarray(tokenizer([t.format(c) for c in chunk for t in templates]))
        t1 = device_clock(device)
        emb = encode_text_fn(torch.from_numpy(tokens).to(device))
        emb = emb.reshape(len(chunk), len(templates), -1).mean(dim=1)
        weights.append(emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True))
        tok_s, enc_s = tok_s + t1 - t0, enc_s + device_clock(device) - t1
    if stats is not None:
        stats.update(tokenize_s=tok_s, encode_s=enc_s)
    return torch.cat(weights, dim=0).T


def zero_shot_eval(encode_image_fn, classifier: torch.Tensor, batches) -> dict:
    """batches yield {'image': NHWC tensor, 'label': (B,) ints}; returns
    top-1/top-5 (%) over the samples whose label is not -1 (padding) and
    their count `n`."""
    top1 = top5 = n = 0
    for batch in batches:
        feats = encode_image_fn(batch["image"])
        logits = feats @ classifier
        pred5 = logits.topk(min(5, logits.shape[-1]), dim=-1).indices.cpu().numpy()
        labels = np.asarray(batch["label"])
        keep = labels >= 0
        pred5, labels = pred5[keep], labels[keep]
        top1 += int((pred5[:, 0] == labels).sum())
        top5 += int((pred5 == labels[:, None]).any(-1).sum())
        n += len(labels)
    return {"zeroshot_top1": 100.0 * top1 / max(n, 1),
            "zeroshot_top5": 100.0 * top5 / max(n, 1), "n": n}
