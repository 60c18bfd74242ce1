#!/usr/bin/env python3
"""Smoke run of cream_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, one or more lines each (any failure raises, so the script exits
non-zero):
  1. device: requires CUDA; prints the card's name and power limit
  2. build: compiles the CUDA kernels from csrc/ into build/
  3. K1 vs plain: the window-attention forward kernel against
     `window_attention_ref` on the card, bf16 and fp32, at TinyViT-21M's
     three stage shapes (bs256) and a Swin-T stage-0 qkv_major + shift-mask
     case; kernel, plain and one-call library (SDPA) times
  4. K2 vs plain: the backward kernel against `window_attention_bwd_ref` at
     the same shapes, bf16 and fp32; dbias the same bits on two launches;
     kernel, plain and library (SDPA backward) times, and the K1+K2
     autograd.Function pair against SDPA forward+backward
  5. grads: at a small fp32 shape, the autograd.Function's grads against
     autograd of the plain forward
  6. golden: TinyViT-21M-224 fp32 on seeded weights against the JAX
     package's logits stored in tests/data/torch_port/
  7. train golden: one fp32 TinyViT-21M-224 train step (B=2) against the
     JAX package's loss and per-param grad norms stored beside them
  8. main path (eval): TinyViT-21M-224 bf16 at bs256 through
     cli.inference.predict and cli.speed_test.throughput, kernel path against
     the plain-attention path on the same weights
  9. main path (train): TinyViT-21M-224 bf16 at bs256 through
     train.make_train_step: 10 K1 + 10 K2 launches per step, the loss falls
     over 10 steps on one batch, kernel path against plain path on the same
     weights and batch, train img/s of both, peak memory
 10. K5 vs plain: the CGA attention-core kernel against `cga_attention_ref`,
     bf16 and fp32, at EfficientViT-M5 bs512's and M0 bs1024's per-head
     shapes; kernel, plain and one-call library (SDPA) times
 11. K4 vs plain: the fused CGA kernel against `fused_cga_ref` on a seeded
     module's fold at the same stage shapes, bf16 and fp32; kernel, plain
     and unfused "plain"-route module times (no single library call
     computes the cascade)
 12. EfficientViT golden: M5 fp32 on seeded weights against the JAX
     package's logits stored in tests/data/torch_port/, on each of the
     three attention routes
 13. main path (EfficientViT eval): M5 bf16 bs512 and M0 bf16 bs1024
     through cli.inference.predict and cli.speed_test.throughput: the
     default "cascade" route (one K4 launch per attention block), the
     "core" route (one K5 launch per head) and the "plain" route on the same
     weights; top-1 agreement and logits against "plain"; img/s of the
     three routes, interleaved
The line before the last is a JSON summary of the kernels; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import copy
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
from cream_tpu_torch.cli.speed_test import (card_info, throughput,  # noqa: E402
                                            train_throughput)
from cream_tpu_torch.models import create_model  # noqa: E402
from cream_tpu_torch.models.efficientvit import CascadedGroupAttention  # noqa: E402
from cream_tpu_torch.nn.attention import WindowBiasAttention  # noqa: E402
from cream_tpu_torch.ops import build, cga, cga_core  # noqa: E402
from cream_tpu_torch.ops import window_attention as wa  # noqa: E402
from cream_tpu_torch.ops.window import window_partition  # noqa: E402
from cream_tpu_torch.train import TrainState, make_adamw, make_train_step  # noqa: E402
from cream_tpu_torch.train.losses import soft_target_ce  # noqa: E402
from cream_tpu_torch.train.optim import global_norm  # noqa: E402
from cream_tpu_torch.train.steps import loss_and_grads  # noqa: E402
from cream_tpu_torch.zoo.load import seeded_state_dict  # noqa: E402

DATA = ROOT / "tests" / "data" / "torch_port"
GOLDEN = DATA / "tinyvit_21m_224_seed0.npz"
TRAIN_GOLDEN = DATA / "tinyvit_21m_224_train_seed0.npz"
EVIT_GOLDEN = DATA / "efficientvit_m5_seed0.npz"
BATCH = 256
# NVIDIA H100 SXM data-sheet peaks (dense): HBM bytes/s, bf16 and fp32
# tensor-core FLOP/s (TF32 for fp32 inputs)
HBM_BPS = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 495e12}
# (name, B, map, window, heads, kd=dv, blocks per TinyViT-21M forward)
TINYVIT_SHAPES = [("stage1", BATCH, 28, 7, 6, 32, 2),
                  ("stage2", BATCH, 14, 14, 12, 32, 6),
                  ("stage3", BATCH, 7, 7, 18, 32, 2)]
# EfficientViT main paths: (model, batch) and each attention stage at 224 as
# (name, windows, ws, C, heads, per-head depthwise kernels, blocks per forward)
EVIT_PATHS = [("efficientvit_m5", 512), ("efficientvit_m0", 1024)]
EVIT_STAGES = {
    "efficientvit_m5": [("m5_s0", 2048, 7, 192, 3, (7, 5, 3), 1),
                        ("m5_s1", 512, 7, 288, 3, (7, 5, 3), 3),
                        ("m5_s2", 512, 4, 384, 4, (7, 5, 3, 3), 4)],
    "efficientvit_m0": [("m0_s0", 4096, 7, 64, 4, (5, 5, 5, 5), 1),
                        ("m0_s1", 1024, 7, 128, 4, (5, 5, 5, 5), 2),
                        ("m0_s2", 1024, 4, 192, 4, (5, 5, 5, 5), 3)],
}
KD = 16


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


def bound_ms(B, H, ws, heads, d, dtype, backward: bool) -> tuple[float, str]:
    """Least time the card could take for the work of K1 (forward) or K2
    (backward) at one stage shape: the larger of the bytes it must move
    (each input read once, each output written once) over HBM bandwidth and
    its products' FLOPs over the peak rate for the input type."""
    e = torch.finfo(dtype).bits // 8
    L, N, pix = heads * 3 * d, ws * ws, B * H * H
    windows = B * (H // ws) ** 2
    nbytes = pix * L * e + heads * N * N * 4 + L * e      # qkv, bias, qkv bias
    if backward:   # + dout; dqkv, dbias. Q.K^T, dP, dQ, dK, dV
        nbytes += pix * heads * d * e + pix * L * e + heads * N * N * 4
        flops = windows * heads * 2 * N * N * 5 * d
    else:          # out. Q.K^T and P.V
        nbytes += pix * heads * d * e
        flops = windows * heads * 2 * N * N * 2 * d
    return roofline_ms(nbytes, flops, dtype)


def roofline_ms(nbytes: float, flops: float, dtype: torch.dtype) -> tuple[float, str]:
    """The larger of `nbytes` over HBM bandwidth and `flops` over the peak
    rate for `dtype`, in ms, and which of the two it is."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sdpa_windows(qkv, bias, dout, kw):
    """The library call's operands: the bias-folded qkv (and dout, if given)
    partitioned into (windows, heads, N, d) and the bias as a float
    attn_mask, all leaves that take grads."""
    ws, h, d = kw["window"], kw["heads"], kw["kd"]
    x = qkv + kw["qkv_bias"].to(qkv.dtype)
    w = window_partition(x, ws)[0]
    q, k, v = (t.transpose(1, 2).contiguous().requires_grad_()
               for t in wa.split_qkv(w, kw["layout"], h, d, d))
    mask = bias.to(qkv.dtype)[None].contiguous().requires_grad_()
    if dout is None:
        return (q, k, v, mask), None
    do = window_partition(dout, ws)[0].unflatten(-1, (h, d)).transpose(1, 2).contiguous()
    return (q, k, v, mask), do


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
                (q, k, v, m), _ = sdpa_windows(args[0], args[1], None, kw)
                with torch.inference_mode():
                    k_ms = cuda_ms(lambda: wa.fused_window_attention(*args, **kw))
                    p_ms = cuda_ms(lambda: wa.window_attention_ref(*args, **kw))
                    l_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=m))
                b_ms, by = bound_ms(B, H, ws, heads, d, dtype, backward=False)
                times[name] = dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                                   bound_ms=b_ms, bound_by=by)
                print(f"k1 time {name} bf16 B={B}: kernel {k_ms:.4f} ms, "
                      f"plain {p_ms:.4f} ms, library (SDPA fwd on windows) {l_ms:.4f} ms, "
                      f"bound {b_ms:.4f} ms ({by}) [{card_info()}]")
    return worst_bf16, times


def bwd_bound(dtype, ref: torch.Tensor) -> float:
    """dqkv max-abs bound of K2 vs plain: bf16, two ulps at the largest
    |dqkv| (both round the same fp32 sums, taken in other orders); fp32,
    1e-5 of the largest |dqkv|."""
    top = ref.abs().max().item()
    if dtype == torch.bfloat16:
        return 2.0 ** (np.floor(np.log2(top)) - 6)
    return 1e-5 * top


def phase_k2(gen) -> tuple[float, dict]:
    """K2 against its plain version; dbias bits on two launches; times."""
    worst_bf16, times = 0.0, {}
    cases = [(n, B, H, ws, h, d, False, "head_major") for n, B, H, ws, h, d, _ in TINYVIT_SHAPES]
    cases.append(("swin_t_stage0", 64, 56, 7, 3, 32, True, "qkv_major"))
    for name, B, H, ws, heads, d, mask, layout in cases:
        for dtype in (torch.bfloat16, torch.float32):
            args, kw = k1_case(gen, B, H, ws, heads, d, dtype, layout, mask)
            dout = torch.randn(B, H, H, heads * d, generator=gen, device="cuda").to(dtype)
            dqkv, dbias, dqb = wa.fused_window_attention_bwd(*args, dout, **kw)
            dqkv2, dbias2, _ = wa.fused_window_attention_bwd(*args, dout, **kw)
            torch.cuda.synchronize()
            ref = wa.window_attention_bwd_ref(*args, dout, **kw)
            err = (dqkv.float() - ref[0].float()).abs().max().item()
            lim = bwd_bound(dtype, ref[0].float())
            db_err = (dbias - ref[1]).abs().max().item()
            db_lim = 1e-4 * ref[1].abs().max().item()
            qb_err = (dqb.float() - ref[2].float()).abs().max().item()
            # the token sum of dqkv elements that may differ by an ulp
            qb_lim = (2 ** -6 if dtype == torch.bfloat16 else 1e-4) * \
                ref[2].float().abs().max().item()
            same = torch.equal(dbias, dbias2) and torch.equal(dqkv, dqkv2)
            print(f"k2 {name} {layout}{' +mask' if mask else ''} B={B} {H}x{H} "
                  f"ws={ws} heads={heads} d={d} {str(dtype).split('.')[-1]}: "
                  f"dqkv max_abs_err={err:.3e} bound={lim:.3e}; dbias "
                  f"max_abs_err={db_err:.3e} bound={db_lim:.3e}; d(qkv_bias) "
                  f"max_abs_err={qb_err:.3e} bound={qb_lim:.3e}; "
                  f"two launches bit-identical: {same}")
            check(err <= lim, f"K2 {name} {dtype} dqkv err {err} > {lim}")
            check(db_err <= db_lim, f"K2 {name} {dtype} dbias err {db_err} > {db_lim}")
            check(qb_err <= qb_lim, f"K2 {name} {dtype} d(qkv_bias) err {qb_err} > {qb_lim}")
            check(same, f"K2 {name} {dtype}: two launches differ")
            if dtype == torch.bfloat16 and name.startswith("stage"):
                worst_bf16 = max(worst_bf16, err)
                times[name] = k2_times(args, kw, dout, B, H, ws, heads, d, dtype)
                t = times[name]
                print(f"k2 time {name} bf16 B={B}: kernel {t['ms']:.4f} ms, plain "
                      f"{t['plain_ms']:.4f} ms, library (SDPA backward on windows) "
                      f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
                      f"({t['bound_by']}); fwd+bwd: K1+K2 autograd.Function "
                      f"{t['pair_ms']:.4f} ms, SDPA {t['library_pair_ms']:.4f} ms "
                      f"[{card_info()}]")
    return worst_bf16, times


def k2_times(args, kw, dout, B, H, ws, heads, d, dtype) -> dict:
    qkv, bias, _ = args
    k_ms = cuda_ms(lambda: wa.fused_window_attention_bwd(qkv, bias, None, dout, **kw))
    p_ms = cuda_ms(lambda: wa.window_attention_bwd_ref(qkv, bias, None, dout, **kw))
    kw_leaf = {k: v for k, v in kw.items() if k != "qkv_bias"}
    leaves = [t.clone().requires_grad_() for t in (qkv, bias, kw["qkv_bias"])]

    def pair():
        out = wa.fused_window_attention(leaves[0], leaves[1], qkv_bias=leaves[2], **kw_leaf)
        torch.autograd.grad(out, leaves, dout)

    ops, do = sdpa_windows(qkv, bias, dout, kw)
    out = F.scaled_dot_product_attention(*ops[:3], attn_mask=ops[3])
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(out, ops, do, retain_graph=True))

    def lib_pair():
        o = F.scaled_dot_product_attention(*ops[:3], attn_mask=ops[3])
        torch.autograd.grad(o, ops, do)

    b_ms, by = bound_ms(B, H, ws, heads, d, dtype, backward=True)
    return dict(ms=k_ms, plain_ms=p_ms, library_ms=lib_bwd, bound_ms=b_ms,
                bound_by=by, pair_ms=cuda_ms(pair), library_pair_ms=cuda_ms(lib_pair))


def phase_grads(gen) -> None:
    """fp32 at a small shape: the K1+K2 autograd.Function's grads against
    autograd of the plain forward (P's rounding to fp32 is the identity)."""
    for layout, mask in (("head_major", False), ("qkv_major", True)):
        args, kw = k1_case(gen, 2, 14, 7, 3, 32, torch.float32, layout, mask)
        qkv, bias, m = args
        kw.pop("qkv_bias")
        qb = torch.randn(qkv.shape[-1], generator=gen, device="cuda") * 0.1
        leaves = [t.clone().requires_grad_() for t in (qkv, bias, qb)]
        out = wa.fused_window_attention(leaves[0], leaves[1], m, qkv_bias=leaves[2], **kw)
        dout = torch.randn(out.shape, generator=gen, device="cuda")
        got = torch.autograd.grad(out, leaves, dout)
        plain = [t.clone().requires_grad_() for t in (qkv, bias, qb)]
        ref = wa.window_attention_ref(plain[0], plain[1], m, qkv_bias=plain[2], **kw)
        want = torch.autograd.grad(ref, plain, dout)
        errs = [((g - w).abs().max() / w.abs().max()).item() for g, w in zip(got, want)]
        print(f"grads {layout}{' +mask' if mask else ''} fp32 autograd.Function vs "
              f"autograd of the plain forward: max_abs_err / max |grad| for "
              f"qkv, bias, qkv_bias = {', '.join(f'{e:.2e}' for e in errs)} (bound 1e-5)")
        check(max(errs) <= 1e-5, f"autograd.Function grads {layout}: {errs}")


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


def phase_train_golden() -> None:
    """One fp32 TinyViT-21M-224 train step at B=2 (drop path 0, TF32 off)
    against the JAX package's, stored by tests/test_torch_train.py."""
    g = np.load(TRAIN_GOLDEN)
    rng = np.random.default_rng(int(g["input_seed"]))
    x = rng.standard_normal((2, 224, 224, 3)).astype(np.float32)
    y = np.eye(1000, dtype=np.float32)[rng.integers(0, 1000, 2)]
    m = create_model("tiny_vit_21m_224", device="cuda", dtype=torch.float32,
                     drop_path_rate=0.0)
    m.load_state_dict(seeded_state_dict(m, int(g["weight_seed"])))
    loss, _, grads = loss_and_grads(m, {"image": torch.from_numpy(x).cuda(),
                                        "label": torch.from_numpy(y).cuda()},
                                    soft_target_ce)
    loss_err = abs(float(loss) - float(g["loss"])) / float(g["loss"])
    gn_err = abs(float(global_norm(grads.values())) - float(g["grad_norm"])) / float(g["grad_norm"])
    check(sorted(grads) == list(g["names"]), "train golden: param names differ")
    got = np.asarray([grads[n].norm().item() for n in g["names"]])
    # per tensor rel 1e-3; grads that are zero up to float noise (the last
    # fc2 bias of stages 1 and 2, before PatchMerging's train-mode BN) at
    # 1e-7 of the norm
    floor = 1e-7 * float(g["grad_norm"])
    diff = np.abs(got - g["grad_norms"])
    excess = diff - (1e-3 * g["grad_norms"] + floor)
    above = g["grad_norms"] > 100 * floor
    worst = float((diff[above] / g["grad_norms"][above]).max())
    print(f"train golden tiny_vit_21m_224 fp32 B=2 vs JAX: loss rel err {loss_err:.2e} "
          f"(bound 1e-4), grad_norm rel err {gn_err:.2e} (bound 1e-4), per-tensor grad "
          f"norms worst rel err {worst:.2e} over the {int(above.sum())} tensors above "
          f"100x the noise floor (bound 1e-3); the {int((~above).sum())} at float noise "
          f"within {float(diff[~above].max()):.1e} (floor {floor:.1e})")
    check(loss_err <= 1e-4, f"train golden loss rel err {loss_err}")
    check(gn_err <= 1e-4, f"train golden grad_norm rel err {gn_err}")
    check(bool((excess <= 0).all()), "train golden per-tensor grad norms")


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
    """The eval main path; returns its K1 launches."""
    dtype = torch.bfloat16
    gen = torch.Generator("cuda").manual_seed(0)
    model = create_model("tiny_vit_21m_224", device="cuda", dtype=dtype)
    model.load_state_dict(seeded_state_dict(model, 0))
    n_attn = sum(isinstance(m, WindowBiasAttention) for m in model.modules())
    x = smooth_images(gen, BATCH).to(dtype)
    noise = torch.randn(BATCH, 224, 224, 3, generator=gen, device="cuda").to(dtype)
    warmup, iters = 3, 20

    wa.LAUNCHES = wa.BWD_LAUNCHES = 0
    logits = predict(model, x)
    per_forward = wa.LAUNCHES
    ips_k1 = throughput(model, BATCH, 224, dtype, iters, warmup)
    launches = wa.LAUNCHES
    check(per_forward == n_attn == 10, f"{per_forward} K1 launches per forward, want 10")
    check(launches == per_forward * (1 + warmup + iters),
          f"{launches} K1 launches in the main path, want {per_forward * (1 + warmup + iters)}")
    check(wa.BWD_LAUNCHES == 0, "eval launched K2")
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


def phase_train() -> tuple[int, int]:
    """The train main path: TinyViT-21M-224 bf16 bs256, AdamW as the
    trainer builds it, drop path 0.2. Returns its K1 and K2 launches."""
    dtype = torch.bfloat16
    gen = torch.Generator("cuda").manual_seed(1)
    model = create_model("tiny_vit_21m_224", device="cuda", dtype=dtype)
    model.load_state_dict(seeded_state_dict(model, 0))
    plain = copy.deepcopy(model)
    set_kernel(plain, False)
    x = smooth_images(gen, BATCH).to(dtype)
    labels = torch.randint(0, 1000, (BATCH,), generator=gen, device="cuda")
    batch = {"image": x, "label": F.one_hot(labels, 1000).float()}

    def new_state(m):
        return TrainState(m, make_adamw(1e-3, weight_decay=0.05, clip_grad=5.0,
                                        params=dict(m.named_parameters())))

    step = make_train_step(loss_fn=soft_target_ce)
    state, n_steps, warmup, iters = new_state(model), 10, 3, 10
    torch.cuda.reset_peak_memory_stats()
    wa.LAUNCHES = wa.BWD_LAUNCHES = 0
    losses, first = [], None
    for i in range(n_steps):
        state, metrics = step(state, batch, 0)
        first = first or metrics
        losses.append(float(metrics["loss"]))
        if i == 0:
            per_step = (wa.LAUNCHES, wa.BWD_LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ips_k = train_throughput(model, BATCH, 224, dtype, iters, warmup)
    launches = (wa.LAUNCHES, wa.BWD_LAUNCHES)
    want = 10 * (n_steps + warmup + iters)
    check(per_step == (10, 10), f"{per_step} K1/K2 launches per train step, want 10 each")
    check(launches == (want, want), f"{launches} K1/K2 launches in the train path, want {want}")

    torch.cuda.reset_peak_memory_stats()
    pstate = new_state(plain)
    _, pmetrics = step(pstate, batch, 0)
    peak_plain = torch.cuda.max_memory_allocated() / 2 ** 30
    ips_p = train_throughput(plain, BATCH, 224, dtype, iters, warmup)
    ips_p2 = train_throughput(plain, BATCH, 224, dtype, iters, warmup)
    ips_k2 = train_throughput(model, BATCH, 224, dtype, iters, warmup)
    check(wa.LAUNCHES == launches[0] + 10 * (warmup + iters) and
          wa.BWD_LAUNCHES == launches[1] + 10 * (warmup + iters),
          "the plain path launched K1/K2 or the kernel path did not")

    l_k, l_p = float(first["loss"]), float(pmetrics["loss"])
    g_k, g_p = float(first["grad_norm"]), float(pmetrics["grad_norm"])
    # bf16 logits and log-softmax: the loss terms sit on a bf16 grid, so the
    # paths may differ by rounding steps there (2 ulps at the loss); the
    # grads flow through bf16 activations rounded at other points, 2%
    loss_lim = 2 * 2.0 ** (np.floor(np.log2(l_p)) - 7)
    card = card_info()
    print(f"train tiny_vit_21m_224 bf16 B={BATCH}: K1/K2 launches per step="
          f"{per_step[0]}/{per_step[1]}, loss over {n_steps} steps on one batch: "
          f"{', '.join(f'{v:.4f}' for v in losses)}")
    print(f"train step 1 kernel vs plain path: loss {l_k:.5f} vs {l_p:.5f} "
          f"(|diff| {abs(l_k - l_p):.2e}, bound {loss_lim:.2e}); grad_norm {g_k:.4f} "
          f"vs {g_p:.4f} (rel diff {abs(g_k - g_p) / g_p:.2e}, bound 2e-2)")
    print(f"train throughput bf16 B={BATCH}: kernel path {ips_k:.1f} / {ips_k2:.1f} img/s, "
          f"plain attention {ips_p:.1f} / {ips_p2:.1f} img/s; peak memory "
          f"{peak:.2f} GiB (kernel path), {peak_plain:.2f} GiB (plain) [{card}]")
    check(all(np.isfinite(losses)), "train loss not finite")
    check(losses[-1] < losses[0], f"train loss did not fall: {losses}")
    check(abs(l_k - l_p) <= loss_lim, f"kernel vs plain loss {l_k} vs {l_p}")
    check(abs(g_k - g_p) <= 2e-2 * g_p, f"kernel vs plain grad_norm {g_k} vs {g_p}")
    return launches


def k5_bound_ms(W: int, N: int, d: int, dtype) -> tuple[float, str]:
    """K5's least time: q, k, v and the bias read once, out written once;
    Q.K^T and P.V."""
    e = torch.finfo(dtype).bits // 8
    nbytes = W * N * (2 * KD + d) * e + N * N * 4 + W * N * d * e
    return roofline_ms(nbytes, W * 2 * N * N * (KD + d), dtype)


def phase_k5(gen) -> tuple[float, dict]:
    """K5 against its plain version at the EfficientViT per-head shapes;
    bf16 times of the kernel, the plain version and SDPA."""
    worst_bf16, times = 0.0, {}
    for model, _ in EVIT_PATHS:
        for name, W, ws, C, heads, _, blocks in EVIT_STAGES[model]:
            N, d = ws * ws, C // heads
            for dtype in (torch.bfloat16, torch.float32):
                q, k = (torch.randn(W, N, KD, generator=gen, device="cuda").to(dtype)
                        for _ in range(2))
                v = torch.randn(W, N, d, generator=gen, device="cuda").to(dtype)
                bias = torch.randn(N, N, generator=gen, device="cuda") * 0.5
                args = (q, k, v, bias, KD ** -0.5)
                with torch.inference_mode():
                    out = cga_core.cga_attention(*args)
                    torch.cuda.synchronize()
                    ref = cga_core.cga_attention_ref(*args)
                err = (out.float() - ref.float()).abs().max().item()
                lim = bound(dtype, ref.float())
                print(f"k5 {name} W={W} N={N} kd={KD} d={d} {str(dtype).split('.')[-1]}: "
                      f"max_abs_err={err:.3e} bound={lim:.3e} (elements differing: "
                      f"{(out != ref).float().mean().item():.2e})")
                check(err <= lim, f"K5 {name} {dtype} err {err} > {lim}")
                if dtype != torch.bfloat16:
                    continue
                worst_bf16 = max(worst_bf16, err)
                lq, lk, lv = (t[:, None] for t in (q, k, v))    # (W, 1, N, .)
                mask = bias.to(dtype)
                with torch.inference_mode():
                    k_ms = cuda_ms(lambda: cga_core.cga_attention(*args))
                    p_ms = cuda_ms(lambda: cga_core.cga_attention_ref(*args))
                    l_ms = cuda_ms(lambda: F.scaled_dot_product_attention(lq, lk, lv,
                                                                          attn_mask=mask))
                b_ms, by = k5_bound_ms(W, N, d, dtype)
                times[name] = dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms,
                                   bound_by=by, per_forward=blocks * heads)
                print(f"k5 time {name} bf16 W={W}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
                      f"library (SDPA on (W, 1, N, d), bias as attn_mask) {l_ms:.4f} ms, "
                      f"bound {b_ms:.4f} ms ({by}) [{card_info()}]")
    return worst_bf16, times


def seeded_cga(C: int, heads: int, ws: int, kernels, dtype, seed: int) -> CascadedGroupAttention:
    m = CascadedGroupAttention(C, KD, heads, C / (KD * heads), ws, kernels,
                               device="cuda", dtype=dtype).eval()
    m.load_state_dict(seeded_state_dict(m, seed))
    return m


def k4_bound_ms(W: int, ws: int, C: int, heads: int, kernels, dtype) -> tuple[float, str]:
    """K4's least time: x read and out written once, the folded weights and
    the bias read once; the qkv and proj products, the depthwise taps that
    fall inside the window (of each head's own kernel), Q.K^T and P.V."""
    e = torch.finfo(dtype).bits // 8
    N, d = ws * ws, C // heads
    L = 2 * KD + d
    ks_max = max(kernels[:heads])
    nbytes = (2 * W * N * C * e + (heads * d * L + C * C) * e
              + (heads * N * N + heads * L + heads * ks_max * ks_max * KD + heads * KD + C) * 4)
    taps = 0
    for ks in kernels[:heads]:
        p = ks // 2
        inside = [sum(0 <= y + t - p < ws for t in range(ks)) for y in range(ws)]
        taps += sum(inside) ** 2
    flops = W * (heads * 2 * N * d * L + 2 * taps * KD + heads * 2 * N * N * (KD + d)
                 + 2 * N * C * C)
    return roofline_ms(nbytes, flops, dtype)


def k4_bound(dtype, ref: torch.Tensor) -> float:
    """Max-abs bound of K4 vs plain: bf16, 8 ulps at the largest |out|, four
    times `bound`'s (an ulp of difference in one head's rounded output feeds
    the next head's qkv and the projection's sum over C channels); fp32 as
    `bound` (fp32 sums in other orders through the cascade)."""
    return bound(dtype, ref) * (4 if dtype == torch.bfloat16 else 1)


def phase_k4(gen) -> tuple[float, dict]:
    """K4 against its plain version on seeded modules' folds at the
    EfficientViT stage shapes; bf16 times of the kernel, the plain version
    and the unfused "plain"-route module."""
    worst_bf16, times = 0.0, {}
    for model, _ in EVIT_PATHS:
        for name, W, ws, C, heads, kernels, blocks in EVIT_STAGES[model]:
            d = C // heads
            for dtype in (torch.bfloat16, torch.float32):
                m = seeded_cga(C, heads, ws, kernels, dtype, seed=C + ws)
                x = torch.randn(W, ws, ws, C, generator=gen, device="cuda").to(dtype)
                kw = dict(ws=ws, heads=heads, c_in=d, kd=KD, d=d, ks_max=m.ks_max)
                ops = (x, m.attention_biases, m.attention_bias_idxs, *m.folded())
                with torch.inference_mode():
                    out = cga.fused_cga(*ops, **kw)
                    torch.cuda.synchronize()
                    ref = cga.fused_cga_ref(*ops, **kw)
                err = (out.float() - ref.float()).abs().max().item()
                lim = k4_bound(dtype, ref.float())
                ulp = bf16_ulp(ref.float().abs().max().clamp_min(1.0)).item()
                print(f"k4 {name} W={W} ws={ws} C={C} heads={heads} kernels={kernels} "
                      f"{str(dtype).split('.')[-1]}: max_abs_err={err:.3e} bound={lim:.3e} "
                      f"({err / ulp:.2f} bf16 ulps at max |out|; elements differing: "
                      f"{(out != ref).float().mean().item():.2e})")
                check(err <= lim, f"K4 {name} {dtype} err {err} > {lim}")
                if dtype != torch.bfloat16:
                    continue
                worst_bf16 = max(worst_bf16, err)
                with torch.inference_mode():
                    k_ms = cuda_ms(lambda: cga.fused_cga(*ops, **kw))
                    p_ms = cuda_ms(lambda: cga.fused_cga_ref(*ops, **kw))
                    m.attn_kernel = "plain"
                    u_ms = cuda_ms(lambda: m(x))
                b_ms, by = k4_bound_ms(W, ws, C, heads, kernels, dtype)
                times[name] = dict(ms=k_ms, plain_ms=p_ms, module_ms=u_ms, bound_ms=b_ms,
                                   bound_by=by, per_forward=blocks)
                print(f"k4 time {name} bf16 W={W}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
                      f"unfused plain-route CGA module {u_ms:.4f} ms (no single library call "
                      f"computes the cascade), bound {b_ms:.4f} ms ({by}) [{card_info()}]")
    return worst_bf16, times


def phase_evit_golden() -> None:
    """EfficientViT-M5 fp32 B=2 on seeded weights against the JAX logits,
    on each attention route, TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = np.load(EVIT_GOLDEN)
    x = np.random.default_rng(int(g["input_seed"])).standard_normal(
        (2, 224, 224, 3)).astype(np.float32)
    m = create_model("efficientvit_m5", device="cuda", dtype=torch.float32)
    m.load_state_dict(seeded_state_dict(m, int(g["weight_seed"])))
    # fp32 with TF32 off; cuDNN/cuBLAS/K4/K5 sum in other orders than the
    # CPU reference (the port matches it to ~1e-6 on the CPU)
    lim = 1e-3
    for route in ("cascade", "core", "plain"):
        m.set_attn_kernel(route)
        cga.LAUNCHES = cga_core.LAUNCHES = 0
        logits = predict(m, torch.from_numpy(x)).cpu().numpy()
        err = float(np.abs(logits - g["logits"]).max())
        print(f"golden efficientvit_m5 fp32 B=2 route {route} vs JAX logits: "
              f"max_abs_err={err:.3e} bound={lim:.1e} (K4/K5 launches "
              f"{cga.LAUNCHES}/{cga_core.LAUNCHES})")
        check(logits.shape == (2, 1000) and bool(np.isfinite(logits).all()),
              f"golden logits ({route})")
        check(err <= lim, f"EfficientViT golden ({route}) err {err} > {lim}")


def bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at |t| (elementwise)."""
    return 2.0 ** (torch.floor(torch.log2(t.abs().clamp_min(2.0 ** -126))) - 7)


def top1_agreement(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, float, float]:
    """(agreement on all images, share of images whose top-2 margin in `ref`
    is above 4 bf16 ulps at its top logit, agreement on those)."""
    top2 = ref.topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > 4 * bf16_ulp(top2[:, 0])
    same = got.argmax(-1) == ref.argmax(-1)
    return (same.float().mean().item(), decided.float().mean().item(),
            same[decided].float().mean().item())


def phase_evit_main(name: str, batch: int) -> dict:
    """An EfficientViT eval main path on its three attention routes; returns
    each route's (K4, K5) launches in its first run of predict+throughput."""
    dtype = torch.bfloat16
    gen = torch.Generator("cuda").manual_seed(2)
    model = create_model(name, device="cuda", dtype=dtype)
    model.load_state_dict(seeded_state_dict(model, 0))
    cgas = [m for m in model.modules() if isinstance(m, CascadedGroupAttention)]
    blocks, heads = len(cgas), sum(m.heads for m in cgas)
    want = {"efficientvit_m5": (8, 28), "efficientvit_m0": (6, 24)}[name]
    check((blocks, heads) == want, f"{name}: {blocks} blocks, {heads} heads, want {want}")
    x = smooth_images(gen, batch).to(dtype)
    warmup, iters = 3, 10
    runs = 1 + warmup + iters
    launches, logits, ips = {}, {}, {}
    for route, per in (("cascade", (blocks, 0)), ("core", (0, heads)), ("plain", (0, 0))):
        model.set_attn_kernel(route)
        wa.LAUNCHES = wa.BWD_LAUNCHES = cga.LAUNCHES = cga_core.LAUNCHES = 0
        logits[route] = predict(model, x)
        per_forward = (cga.LAUNCHES, cga_core.LAUNCHES)
        ips[route] = [throughput(model, batch, 224, dtype, iters, warmup)]
        launches[route] = (cga.LAUNCHES, cga_core.LAUNCHES)
        check(per_forward == per, f"{name} {route}: K4/K5 launches per forward "
                                  f"{per_forward}, want {per}")
        check(launches[route] == (runs * per[0], runs * per[1]),
              f"{name} {route}: K4/K5 launches {launches[route]} in the main path")
        check(wa.LAUNCHES == wa.BWD_LAUNCHES == 0, f"{name} launched K1/K2")
        check(logits[route].shape == (batch, 1000) and bool(torch.isfinite(logits[route]).all()),
              f"{name} {route}: logits not finite")
    for route in ("plain", "core", "cascade"):
        model.set_attn_kernel(route)
        ips[route].append(throughput(model, batch, 224, dtype, iters, warmup))
    card = card_info()
    # logits: the routes round at other points (BN folded into bf16 weights
    # for K4; scores and exp(s - max) rounded to bf16 on the plain route),
    # and the differences pass ~45 bf16 residual adds: 8 ulps at the largest
    lim = 8 * bf16_ulp(logits["plain"].abs().max()).item()
    for route in ("cascade", "core"):
        # seeded weights give a near-constant classifier (logits vary by
        # ~0.03 across images, a bf16 ulp is 0.008 at |logit| ~ 2): the
        # top-1 check counts the images whose plain-route top-2 margin is
        # above 4 bf16 ulps, where a correct route cannot flip the answer
        agree, decided, agree_decided = top1_agreement(logits[route], logits["plain"])
        err = (logits[route] - logits["plain"]).abs().max().item()
        print(f"main {name} bf16 B={batch} route {route}: K4/K5 launches per forward="
              f"{launches[route][0] // runs}/{launches[route][1] // runs}, top-1 agreement "
              f"vs plain={agree_decided:.4f} on the {round(decided * batch)} images with a "
              f"margin above 4 bf16 ulps (need >= 0.99 on >= 100), {agree:.4f} on all "
              f"{batch} (not checked), logits max_abs_err={err:.3e} bound={lim:.3e} "
              f"(max |logit| {logits['plain'].abs().max().item():.3f})")
        check(decided * batch >= 100 and agree_decided >= 0.99,
              f"{name} {route}: top-1 agreement {agree_decided} on "
              f"{round(decided * batch)} images")
        check(err <= lim, f"{name} {route}: logits err {err} > {lim}")
    print(f"main throughput {name} bf16 B={batch} (order cascade, core, plain, plain, core, "
          f"cascade): cascade (K4) {ips['cascade'][0]:.1f} / {ips['cascade'][1]:.1f} img/s, "
          f"core (K5) {ips['core'][0]:.1f} / {ips['core'][1]:.1f} img/s, plain "
          f"{ips['plain'][0]:.1f} / {ips['plain'][1]:.1f} img/s [{card}]")
    return launches


def evit_row(name: str, src: str, line: int, launches: int, err: float, t: dict,
             keys: tuple[str, ...], extra: dict) -> dict:
    """A kernel row of the JSON line; times summed over one EfficientViT-M5
    bs512 forward (each stage's time times its launches per forward)."""
    m5 = [n for n, *_ in EVIT_STAGES["efficientvit_m5"]]
    total = {k: sum(t[n][k] * t[n]["per_forward"] for n in m5) for k in keys}
    return {"name": name, "route": "cuda", "source": f"cream_tpu_torch/csrc/{src}",
            "replaces": f"cream_tpu/ops/pallas/{line}", "launches": launches,
            "max_abs_err": err, **total,
            "bound_by": max((t[n] for n in m5), key=lambda r: r["bound_ms"])["bound_by"],
            **extra}


def summed_over_blocks(times: dict, key: str) -> float:
    """A per-shape time summed over the blocks of one TinyViT-21M forward
    (K1) or train step (K2)."""
    return sum(times[n][key] * blocks for n, *_, blocks in TINYVIT_SHAPES)


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

    gen = torch.Generator("cuda").manual_seed(0)
    worst_k1, t1 = phase_k1(gen)
    worst_k2, t2 = phase_k2(gen)
    phase_grads(gen)
    phase_golden()
    phase_train_golden()
    k1_eval = phase_main()
    k1_train, k2_train = phase_train()
    worst_k5, t5 = phase_k5(gen)
    worst_k4, t4 = phase_k4(gen)
    phase_evit_golden()
    evit = {name: phase_evit_main(name, batch) for name, batch in EVIT_PATHS}

    rows = []
    for name, src, line, launches, err, t in (
            ("window_attention_fwd", "window_attention.cu", 190, k1_eval + k1_train,
             worst_k1, t1),
            ("window_attention_bwd", "window_attention_bwd.cu", 268, k2_train,
             worst_k2, t2)):
        rows.append({
            "name": name, "route": "cuda", "source": f"cream_tpu_torch/csrc/{src}",
            "replaces": f"cream_tpu/ops/pallas/window_attention.py:{line}",
            "launches": launches, "max_abs_err": err,
            **{k: summed_over_blocks(t, k) for k in ("ms", "plain_ms", "bound_ms")},
            "bound_by": t["stage2"]["bound_by"],
            "library_ms": summed_over_blocks(t, "library_ms")})
    rows.append(evit_row(
        "cga_fused", "cga.cu", "cga.py:56", sum(v["cascade"][0] for v in evit.values()),
        worst_k4, t4, ("ms", "plain_ms", "module_ms", "bound_ms"),
        {"library_ms": None, "library_note": "no single PyTorch call computes the whole "
         "cascade; module_ms is the unfused plain-route CGA module on the same input"}))
    rows.append(evit_row(
        "cga_core", "cga_core.cu", "cga_core.py:63", sum(v["core"][1] for v in evit.values()),
        worst_k5, t5, ("ms", "plain_ms", "library_ms", "bound_ms"), {}))
    for key, t in (("K4", t4), ("K5", t5)):
        m0 = {k: sum(t[n][k] * t[n]["per_forward"] for n, *_ in EVIT_STAGES["efficientvit_m0"])
              for k in ("ms", "plain_ms", "bound_ms")}
        print(f"{key} per EfficientViT-M0 bf16 bs1024 forward: kernel {m0['ms']:.4f} ms, "
              f"plain {m0['plain_ms']:.4f} ms, bound {m0['bound_ms']:.4f} ms")
    print(f"kernel times are per TinyViT-21M-224 bf16 bs256 forward (K1) or train "
          f"step (K2), eval path K1 launches {k1_eval}, train path K1/K2 launches "
          f"{k1_train}/{k2_train}; per EfficientViT-M5 bf16 bs512 forward (K4, K5), "
          f"launches on the M5 bs512 + M0 bs1024 eval paths' cascade (K4) and core (K5) routes")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
