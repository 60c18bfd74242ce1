"""A/B of cream_tpu_torch's K4 (the fused cascaded group attention) between
checkouts, on one CUDA card: device times by CUDA-graph replay, so the host's
issue is out of them.

    python3 tools/torch_k4_ab.py TREE [TREE ...]
    python3 tools/torch_k4_ab.py --sweep

Each TREE is the root of a checkout (this one is `.`); they are measured in
the order given, each in a process of its own that imports that tree's
cream_tpu_torch and builds its kernels into TREE/build. Give two trees as
A B B A to see the drift of the card. Per tree it prints one JSON line: K4's
time at EfficientViT-M5 bs512's and M0 bs1024's attention stages (seeded
modules, bf16; the median of 3 rounds of `graph_ms`), summed per forward,
and the whole bf16 eval forward of M5 bs512 and M0 bs1024 on the "cascade"
and "core" routes (the cached folds warmed first); then the card's name and
power limit. `--sweep` times this checkout's bf16 K4 at the same stages
on every windows-a-block count G whose block fits one SM (the kernel takes
any; `launch_plan` picks one), 3 interleaved rounds of `graph_ms`.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

# (name, windows, ws, C, heads, per-head kernels, blocks per forward): chip_smoke's EVIT_STAGES
STAGES = {
    "efficientvit_m5": (512, [("m5_s0", 2048, 7, 192, 3, (7, 5, 3), 1),
                              ("m5_s1", 512, 7, 288, 3, (7, 5, 3), 3),
                              ("m5_s2", 512, 4, 384, 4, (7, 5, 3, 3), 4)]),
    "efficientvit_m0": (1024, [("m0_s0", 4096, 7, 64, 4, (5, 5, 5, 5), 1),
                               ("m0_s1", 1024, 7, 128, 4, (5, 5, 5, 5), 2),
                               ("m0_s2", 1024, 4, 192, 4, (5, 5, 5, 5), 3)]),
}
KD = 16


def graph_ms(torch, fn, iters: int = 10, reps: int = 5) -> float:
    """Device time of one call: `iters` calls in one CUDA graph, the median
    of `reps` replays over `iters` (chip_smoke.graph_ms)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def measure(tree: Path) -> dict:
    sys.path.insert(0, str(tree))
    import torch

    import cream_tpu_torch
    from cream_tpu_torch.models import create_model
    from cream_tpu_torch.models.efficientvit import CascadedGroupAttention
    from cream_tpu_torch.ops import build, cga
    from cream_tpu_torch.zoo.load import seeded_state_dict
    if not torch.cuda.is_available():
        raise RuntimeError("torch_k4_ab: CUDA is not available")
    if Path(cream_tpu_torch.__file__).resolve().parents[1] != tree.resolve():
        raise RuntimeError(f"imported {cream_tpu_torch.__file__}, not {tree}'s package")
    build.load()
    dtype = torch.bfloat16
    gen = torch.Generator("cuda").manual_seed(0)
    res = {"tree": str(tree), "k4": {}, "forward": {}}
    # modules are made outside inference mode: their cached folds read the
    # parameters' version counters
    for model, (batch, stages) in STAGES.items():
        total = 0.0
        for name, W, ws, C, heads, kernels, blocks in stages:
            m = CascadedGroupAttention(C, KD, heads, C / (KD * heads), ws, kernels,
                                       device="cuda", dtype=dtype).eval()
            m.load_state_dict(seeded_state_dict(m, C + ws))
            x = torch.randn(W, ws, ws, C, generator=gen, device="cuda").to(dtype)
            kw = dict(ws=ws, heads=heads, c_in=C // heads, kd=KD, d=C // heads, ks_max=m.ks_max)
            ops = (m.attention_biases, m.attention_bias_idxs, *m.folded())
            with torch.inference_mode():
                ms = statistics.median(
                    graph_ms(torch, lambda: cga.fused_cga(x, *ops, **kw)) for _ in range(3))
            res["k4"][name] = ms
            total += blocks * ms
        res["k4"][f"{model}_forward"] = total
        net = create_model(model, device="cuda", dtype=dtype)
        net.load_state_dict(seeded_state_dict(net, 0))
        x = torch.randn(batch, 224, 224, 3, generator=gen, device="cuda").to(dtype)
        for route in ("cascade", "core"):
            net.set_attn_kernel(route)
            with torch.inference_mode():
                net(x)                                # the folds, cached
                res["forward"][f"{model}_{route}"] = statistics.median(
                    graph_ms(torch, lambda: net(x)) for _ in range(3))
    res["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    return res


def sweep() -> dict:
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import torch

    from cream_tpu_torch.models.efficientvit import CascadedGroupAttention
    from cream_tpu_torch.ops import cga
    from cream_tpu_torch.zoo.load import seeded_state_dict
    dtype = torch.bfloat16
    gen = torch.Generator("cuda").manual_seed(0)
    res = {}
    for model, (_, stages) in STAGES.items():
        for name, W, ws, C, heads, kernels, _ in stages:
            m = CascadedGroupAttention(C, KD, heads, C / (KD * heads), ws, kernels,
                                       device="cuda", dtype=dtype).eval()
            m.load_state_dict(seeded_state_dict(m, C + ws))
            m.folded()
            with torch.inference_mode():
                x = torch.randn(W, ws, ws, C, generator=gen, device="cuda").to(dtype)
                d = C // heads
                kw = dict(ws=ws, heads=heads, c_in=d, kd=KD, d=d, ks_max=m.ks_max)
                ops = (m.attention_biases, m.attention_bias_idxs, *m.folded())
                want = cga.fused_cga(x, *ops, **kw)
                kw.pop("c_in")

                def run(G):
                    return lambda: cga._launch(x, *ops, G, **kw)
                gs = [G for G in range(1, cga.MAX_WINDOWS + 1)
                      if cga._bf16_smem(ws, heads, KD, d, m.ks_max, G) <= cga.SMEM_LIMIT]
                for G in gs:
                    if not torch.equal(run(G)(), want):
                        raise RuntimeError(f"{name}: G={G} gives other bits")
                rounds = [[graph_ms(torch, run(G)) for G in gs] for _ in range(3)]
                res[name] = {"plan": cga.launch_plan(W, ws, heads, KD, d, m.ks_max, dtype).windows,
                             **{f"G{G}": statistics.median(r[i] for r in rounds)
                                for i, G in enumerate(gs)}}
    res["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    return res


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(measure(Path(argv[1]))))
        return 0
    if argv == ["--sweep"]:
        print(json.dumps(sweep()))
        return 0
    if not argv:
        print(__doc__)
        return 2
    rc = 0
    for tree in argv:
        proc = subprocess.run([sys.executable, __file__, "--one", tree],
                              capture_output=True, text=True)
        sys.stderr.write(proc.stderr[-4000:])
        lines = proc.stdout.strip().splitlines()
        print(lines[-1] if proc.returncode == 0 and lines
              else json.dumps({"tree": tree, "rc": proc.returncode}))
        rc |= proc.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
