"""Mini-DeiT's 1x1 head transform on the card: three plain PyTorch forms
of out[b, o, n, m] = sum_h w[o, h] · attn[b, h, n, m] on Mini-DeiT-S bs256's
bf16 (256, 6, 196, 196) scores, timed forward and forward + backward by CUDA
events (median of 5 runs of 10), interleaved, with their max difference.

    python3 tools/head_transform_ab.py
"""
import statistics
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from cream_tpu_torch.cli.speed_test import card_info  # noqa: E402

FORMS = {
    "matmul": lambda w, a: torch.matmul(w, a.flatten(2)).view_as(a),
    "conv2d": lambda w, a: F.conv2d(a, w[:, :, None, None]),
    "einsum": lambda w, a: torch.einsum("oh,bhnm->bonm", w, a),
}


def ms(fn, iters=10, reps=5):
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(iters):
            fn()
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e) / iters)
    return statistics.median(out)


def main():
    gen = torch.Generator("cuda").manual_seed(0)
    a = torch.randn(256, 6, 196, 196, generator=gen, device="cuda").bfloat16()
    w = torch.randn(6, 6, generator=gen, device="cuda").bfloat16()
    ref = FORMS["matmul"](w, a).float()
    g = torch.randn_like(a)
    res = {k: {"fwd": [], "fwd_bwd": []} for k in FORMS}
    for rnd in range(2):
        for name in (FORMS if rnd % 2 == 0 else reversed(list(FORMS))):
            f = FORMS[name]
            res[name]["fwd"].append(ms(lambda: f(w, a)))
            ar, wr = a.clone().requires_grad_(), w.clone().requires_grad_()
            res[name]["fwd_bwd"].append(ms(lambda: torch.autograd.grad(f(wr, ar), (ar, wr), g)))
    for name, f in FORMS.items():
        err = (f(w, a).float() - ref).abs().max().item()
        print(f"{name}: fwd {res[name]['fwd']} ms, fwd+bwd {res[name]['fwd_bwd']} ms, "
              f"max |diff| vs matmul {err:.3e}")
    print(card_info())


if __name__ == "__main__":
    main()
