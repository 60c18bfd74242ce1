"""CPU timing of cream_tpu_torch's Pillow-free train recipe and eval
preprocessing against the JAX package's Pillow ones, on one 500 x 375 image.

    PYTHONPATH=. python tools/torch_recipe_timing.py [--images 200]

Prints ms an image (one thread, the mean over seeds) of:
  * `det_aug.make_train_transform(TrainAugConfig())` and
    `transforms.preprocess_pil` at 224, the port's and the JAX package's
    (Pillow; the reference, run here on the CPU as the tests run it);
  * the port's recipe by operation (cProfile's cumulative time of each
    `pil_ops` function), to name the one that dominates;
  * the port's recipe in 1, 2, 4 and 8 threads and the train loader over a
    generated 256-image BMP folder with 1, 2, 4 and 8 worker processes
    (their start included, the fork server's, once a process, not).
The outputs are checked equal on every seed first.
"""
from __future__ import annotations

import argparse
import cProfile
import os
import pstats
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import folder_image, write_folder  # noqa: E402
from cream_tpu_torch.data import det_aug, pil_ops, transforms  # noqa: E402
from cream_tpu_torch.data.imagenet import ImageFolder, Workers, train_loader  # noqa: E402


def per_image_ms(fn, n: int) -> float:
    t0 = time.perf_counter()
    for seed in range(n):
        fn(seed)
    return (time.perf_counter() - t0) * 1e3 / n


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--images", type=int, default=200)
    n = ap.parse_args().images
    from PIL import Image

    from cream_tpu.data import det_aug as jax_det_aug
    from cream_tpu.data import transforms as jax_transforms

    img = folder_image(np.random.default_rng(0), 500, 375)
    pil = Image.fromarray(img)
    port = det_aug.make_train_transform(det_aug.TrainAugConfig())
    ref = jax_det_aug.make_train_transform(jax_det_aug.TrainAugConfig())
    pp, jpp = transforms.eval_preprocess_config(224), jax_transforms.eval_preprocess_config(224)
    for seed in range(n):
        assert np.array_equal(port(img, seed), ref(pil, seed)), seed
    assert np.array_equal(transforms.preprocess_pil(img, pp), jax_transforms.preprocess_pil(pil, jpp))
    print(f"500x375, {n} seeds, one thread, ms an image: recipe port "
          f"{per_image_ms(lambda s: port(img, s), n):.2f}, Pillow "
          f"{per_image_ms(lambda s: ref(pil, s), n):.2f}; eval preprocessing port "
          f"{per_image_ms(lambda s: transforms.preprocess_pil(img, pp), n):.2f}, Pillow "
          f"{per_image_ms(lambda s: jax_transforms.preprocess_pil(pil, jpp), n):.2f}")

    prof = cProfile.Profile()
    prof.enable()
    per_image_ms(lambda s: port(img, s), n)
    prof.disable()
    stats = pstats.Stats(prof).stats
    ops = {fn: v[3] * 1e3 / n for (file, _, fn), v in stats.items()
           if file == pil_ops.__file__ and hasattr(pil_ops, fn) and not fn.startswith("_")}
    print("port recipe by pil_ops function, cumulative ms an image: " + ", ".join(
        f"{k} {v:.2f}" for k, v in sorted(ops.items(), key=lambda kv: -kv[1])))

    rates = []
    for threads in (1, 2, 4, 8):
        t0 = time.perf_counter()
        with ThreadPoolExecutor(threads) as pool:
            list(pool.map(lambda s: port(img, s), range(96)))
        rates.append(96 / (time.perf_counter() - t0))
    print("port recipe in 1/2/4/8 threads: " + " / ".join(f"{r:.1f}" for r in rates)
          + f" img/s (os.cpu_count() {os.cpu_count()})")

    with Workers(len, 2) as pool:     # start the loaders' fork server, once a process
        pool.map(["warm"])
    with tempfile.TemporaryDirectory() as tmp:
        write_folder(Path(tmp), 256, 0)
        ds = ImageFolder(str(Path(tmp) / "train"))
        rates = []
        for workers in (1, 2, 4, 8):
            t0 = time.perf_counter()
            m = sum(len(b["label"]) for b in train_loader(ds, 64, 0, 0, 224, workers,
                                                          transform=port))
            rates.append(m / (time.perf_counter() - t0))
    print("train loader (bs64, 256 BMPs at ImageNet's sizes) with 1/2/4/8 worker processes: "
          + " / ".join(f"{r:.1f}" for r in rates)
          + " img/s, the workers' start included (the fork server's not)")


if __name__ == "__main__":
    main()
