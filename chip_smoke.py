#!/usr/bin/env python3
"""Smoke run of cream_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, one line each (any failure raises, so the script exits non-zero):
  1. device: requires CUDA; prints the card's name and power limit
  2. build: compiles the CUDA kernels from csrc/ into build/
  3. K1 vs plain: the window-attention kernel against `window_attention_ref`
     on the card, bf16 and fp32, at TinyViT-21M's three stage shapes (bs256)
     and a Swin-T stage-0 qkv_major + shift-mask case; kernel and plain times
  4. golden: TinyViT-21M-224 fp32 on seeded weights against the JAX package's
     logits stored in tests/data/torch_port/
  5. main path: TinyViT-21M-224 bf16 at bs256 through cli.inference.predict
     and cli.speed_test.throughput, kernel path against the plain-attention
     path on the same weights
The line before the last is a JSON summary of the kernels; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from cream_tpu_torch.cli.inference import predict  # noqa: E402
from cream_tpu_torch.cli.speed_test import card_info, throughput  # noqa: E402
from cream_tpu_torch.models import create_model  # noqa: E402
from cream_tpu_torch.nn.attention import WindowBiasAttention  # noqa: E402
from cream_tpu_torch.ops import build  # noqa: E402
from cream_tpu_torch.ops import window_attention as wa  # noqa: E402
from cream_tpu_torch.zoo.load import seeded_state_dict  # noqa: E402

GOLDEN = ROOT / "tests" / "data" / "torch_port" / "tinyvit_21m_224_seed0.npz"
BATCH = 256
# (name, B, map, window, heads, kd=dv, blocks per TinyViT-21M forward)
TINYVIT_SHAPES = [("stage1", BATCH, 28, 7, 6, 32, 2),
                  ("stage2", BATCH, 14, 14, 12, 32, 6),
                  ("stage3", BATCH, 7, 7, 18, 32, 2)]


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def bound(dtype: torch.dtype, ref: torch.Tensor) -> float:
    """Max-abs bound of kernel vs plain: bf16, two ulps at the largest |out|
    (P and the output each round to bf16, and sums run in other orders);
    fp32, 1e-5 relative to the largest |out| (fp32 sums in other orders)."""
    top = max(1.0, ref.abs().max().item())
    if dtype == torch.bfloat16:
        return 2.0 ** (np.floor(np.log2(top)) - 6)
    return 1e-5 * top


def cuda_ms(fn, iters: int = 10, reps: int = 5) -> float:
    """Median over `reps` of the mean time of `iters` calls, CUDA events."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def shift_mask(H: int, W: int, ws: int, shift: int, device) -> torch.Tensor:
    """Swin's shifted-window additive mask, (nH*nW, N, N) with 0 / -100."""
    img = torch.zeros(H, W, device=device)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    win = img.view(H // ws, ws, W // ws, ws).permute(0, 2, 1, 3).reshape(-1, ws * ws)
    return (win[:, None, :] != win[:, :, None]).float() * -100.0


def k1_case(gen, B, H, ws, heads, d, dtype, layout="head_major", mask=False):
    L, N = heads * 3 * d, ws * ws
    dev = "cuda"
    qkv = torch.randn(B, H, H, L, generator=gen, device=dev).to(dtype)
    bias = torch.randn(heads, N, N, generator=gen, device=dev) * 0.5
    qb = torch.randn(L, generator=gen, device=dev) * 0.1
    m = shift_mask(H, H, ws, ws // 2, dev) if mask else None
    kw = dict(window=ws, heads=heads, kd=d, dv=d, layout=layout, qkv_bias=qb)
    return (qkv, bias, m), kw


def phase_k1(gen) -> tuple[float, dict]:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    worst_bf16, times = 0.0, {}
    cases = [(n, B, H, ws, h, d, False, "head_major") for n, B, H, ws, h, d, _ in TINYVIT_SHAPES]
    cases.append(("swin_t_stage0", 64, 56, 7, 3, 32, True, "qkv_major"))
    for name, B, H, ws, heads, d, mask, layout in cases:
        for dtype in (torch.bfloat16, torch.float32):
            args, kw = k1_case(gen, B, H, ws, heads, d, dtype, layout, mask)
            with torch.inference_mode():
                out = wa.fused_window_attention(*args, **kw)
                torch.cuda.synchronize()
                ref = wa.window_attention_ref(*args, **kw)
            err = (out.float() - ref.float()).abs().max().item()
            lim = bound(dtype, ref.float())
            differ = (out != ref).float().mean().item()
            print(f"k1 {name} {layout}{' +mask' if mask else ''} "
                  f"B={B} {H}x{H} ws={ws} heads={heads} d={d} "
                  f"{str(dtype).split('.')[-1]}: max_abs_err={err:.3e} bound={lim:.3e} "
                  f"(elements differing: {differ:.2e})")
            check(err <= lim, f"K1 {name} {dtype} err {err} > {lim}")
            if dtype == torch.bfloat16 and name.startswith("stage"):
                worst_bf16 = max(worst_bf16, err)
                with torch.inference_mode():
                    k_ms = cuda_ms(lambda: wa.fused_window_attention(*args, **kw))
                    p_ms = cuda_ms(lambda: wa.window_attention_ref(*args, **kw))
                times[name] = (k_ms, p_ms)
                print(f"k1 time {name} bf16 B={B}: kernel {k_ms:.4f} ms, "
                      f"plain {p_ms:.4f} ms [{card_info()}]")
    return worst_bf16, times


def phase_golden() -> None:
    g = np.load(GOLDEN)
    x = np.random.default_rng(int(g["input_seed"])).standard_normal(
        (2, 224, 224, 3)).astype(np.float32)
    m = create_model("tiny_vit_21m_224", device="cuda", dtype=torch.float32)
    m.load_state_dict(seeded_state_dict(m, int(g["weight_seed"])))
    logits = predict(m, torch.from_numpy(x)).cpu().numpy()
    err = float(np.abs(logits - g["logits"]).max())
    # fp32 with TF32 off; cuDNN/cuBLAS/K1 sum in other orders than the
    # CPU reference (the port matches it to ~3e-6 on the CPU)
    lim = 1e-3
    print(f"golden tiny_vit_21m_224 fp32 B=2 vs JAX logits: "
          f"max_abs_err={err:.3e} bound={lim:.1e}")
    check(logits.shape == (2, 1000) and bool(np.isfinite(logits).all()), "golden logits")
    check(err <= lim, f"golden err {err} > {lim}")


def smooth_images(gen, batch: int, size: int = 224, grid: int = 4) -> torch.Tensor:
    """Random low-frequency images (NHWC, unit std): a grid x grid field of
    normal noise per channel, bicubic-upsampled. With seeded weights, logits
    on white noise barely depend on the image (their fp32 top-2 margin is
    below bf16 resolution for ~10% of images); on these they do."""
    low = torch.randn(batch, 3, grid, grid, generator=gen, device="cuda")
    x = F.interpolate(low, size=size, mode="bicubic", align_corners=False)
    x = x.permute(0, 2, 3, 1)
    return (x / x.std()).contiguous()


def set_kernel(model: torch.nn.Module, on: bool) -> None:
    for mod in model.modules():
        if isinstance(mod, WindowBiasAttention):
            mod.use_kernel = on


def phase_main() -> int:
    dtype = torch.bfloat16
    gen = torch.Generator("cuda").manual_seed(0)
    model = create_model("tiny_vit_21m_224", device="cuda", dtype=dtype)
    model.load_state_dict(seeded_state_dict(model, 0))
    n_attn = sum(isinstance(m, WindowBiasAttention) for m in model.modules())
    x = smooth_images(gen, BATCH).to(dtype)
    noise = torch.randn(BATCH, 224, 224, 3, generator=gen, device="cuda").to(dtype)
    warmup, iters = 3, 20

    wa.LAUNCHES = 0
    logits = predict(model, x)
    per_forward = wa.LAUNCHES
    ips_k1 = throughput(model, BATCH, 224, dtype, iters, warmup)
    launches = wa.LAUNCHES
    check(per_forward == n_attn == 10, f"{per_forward} K1 launches per forward, want 10")
    check(launches == per_forward * (1 + warmup + iters),
          f"{launches} K1 launches in the main path, want {per_forward * (1 + warmup + iters)}")
    check(logits.shape == (BATCH, 1000) and bool(torch.isfinite(logits).all()),
          "main-path logits not finite")

    noise_k1 = predict(model, noise)
    set_kernel(model, False)
    plain = predict(model, x)
    noise_plain = predict(model, noise)
    ips_plain = throughput(model, BATCH, 224, dtype, iters, warmup)
    ips_plain2 = throughput(model, BATCH, 224, dtype, iters, warmup)
    set_kernel(model, True)
    ips_k1_2 = throughput(model, BATCH, 224, dtype, iters, warmup)
    check(wa.LAUNCHES == launches + 10 * (1 + warmup + iters),
          "plain path launched K1 or kernel path did not")
    agree = (logits.argmax(-1) == plain.argmax(-1)).float().mean().item()
    err = (logits - plain).abs().max().item()
    # both paths bf16 with the same rounding points; they differ only where
    # K1's fp32 sums, taken in another order, round P or out to another bf16
    lim = 5e-2
    card = card_info()
    print(f"main tiny_vit_21m_224 bf16 B={BATCH}: K1 launches/forward={per_forward}, "
          f"top-1 agreement kernel vs plain={agree:.4f} (need >= 0.99), "
          f"logits max_abs_err={err:.3e} bound={lim:.1e}")
    noise_agree = (noise_k1.argmax(-1) == noise_plain.argmax(-1)).float().mean().item()
    print(f"main white-noise images (not checked; top-2 margins below bf16 "
          f"resolution): top-1 agreement kernel vs plain={noise_agree:.4f}")
    print(f"main throughput bf16 B={BATCH}: kernel path {ips_k1:.1f} / {ips_k1_2:.1f} img/s, "
          f"plain attention {ips_plain:.1f} / {ips_plain2:.1f} img/s [{card}]")
    check(agree >= 0.99, f"top-1 agreement {agree} < 0.99")
    check(err <= lim, f"kernel vs plain logits err {err} > {lim}")
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: CUDA is not available")
    card = card_info()
    print(card)
    print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.time()
    path = build.build()
    build.load()
    print(f"build: {path.name} in {time.time() - t0:.2f} s")

    worst_bf16, times = phase_k1(torch.Generator("cuda").manual_seed(0))
    phase_golden()
    launches = phase_main()

    # K1 time per TinyViT-21M bs256 bf16 forward: each stage shape's time
    # times the blocks that run it
    ms = sum(times[n][0] * blocks for n, *_, blocks in TINYVIT_SHAPES)
    plain_ms = sum(times[n][1] * blocks for n, *_, blocks in TINYVIT_SHAPES)
    print(card)
    print(json.dumps({"kernels": [{
        "name": "window_attention_fwd", "route": "cuda",
        "source": "cream_tpu_torch/csrc/window_attention.cu",
        "replaces": "cream_tpu/ops/pallas/window_attention.py:190",
        "launches": launches, "max_abs_err": worst_bf16,
        "ms": ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
