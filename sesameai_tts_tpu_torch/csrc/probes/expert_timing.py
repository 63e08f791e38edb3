"""The routed FFN at LFM2-8B-A1B's expert shape on the card, µs a call:
``expert_swiglu`` (the kernel), its plain version, and the library's way,
a loop of ``torch.matmul`` over the hit experts' dense bf16 weights, beside
the bound (each hit expert's int8 weights and scales, x and y once, at
3.35 TB/s).  32 experts of 2,048 × 1,792, top 4 of uniform routing, N rows;
the 32 experts' 352 MB of int8 weights exceed the 50 MB L2, so each call
reads them from device memory.

    python3 sesameai_tts_tpu_torch/csrc/probes/expert_timing.py [--rows 1 16 64]

Prints one JSON line per N.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", "..")))

E, D, FE, K = 32, 2048, 1792, 4


def _events_us(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return 1e3 * start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, nargs="+", default=[1, 16, 64])
    args = ap.parse_args()

    import numpy as np
    import torch
    import torch.nn.functional as F

    from sesameai_tts_tpu_torch.ops import moe
    from sesameai_tts_tpu_torch.ops.quant import quantize_weight

    g = torch.Generator(device="cuda").manual_seed(0)
    w13 = quantize_weight(torch.randn((E, D, 2 * FE), generator=g, device="cuda") / D ** 0.5)
    w2 = quantize_weight(torch.randn((E, FE, D), generator=g, device="cuda") / FE ** 0.5)
    dense13 = (w13["q"].float() * w13["scale"][:, None, :]).to(torch.bfloat16)
    dense2 = (w2["q"].float() * w2["scale"][:, None, :]).to(torch.bfloat16)
    name = torch.cuda.get_device_name(0)
    for n in args.rows:
        rng = np.random.default_rng(n)
        ids = torch.tensor(np.stack([rng.choice(E, K, replace=False) for _ in range(n)]),
                           device="cuda")
        w = torch.rand((n, K), device="cuda")
        w = w / w.sum(-1, keepdim=True)
        x = torch.randn((n, D), device="cuda").to(torch.bfloat16)
        args_ = (x, ids, w, w13["q"], w13["scale"], w2["q"], w2["scale"])

        def library():
            y = torch.zeros((n, D), dtype=torch.float32, device="cuda")
            for e in torch.unique(ids).tolist():
                rows, slot = (ids == e).nonzero(as_tuple=True)
                a = x[rows] @ dense13[e]
                h = F.silu(a[:, :FE].float()).to(torch.bfloat16) * a[:, FE:]
                y.index_add_(0, rows, (h @ dense2[e]).float() * w[rows, slot][:, None])
            return y.to(torch.bfloat16)

        hit = int(torch.unique(ids).numel())
        nbytes = hit * (3 * D * FE + 4 * (2 * FE + D)) + n * (4 * D + 12 * K)
        out = {"card": name, "rows": n, "experts_hit": hit,
               "kernel_us": _events_us(torch, lambda: moe.expert_swiglu(*args_), 20),
               "plain_us": _events_us(torch, lambda: moe.expert_swiglu_plain(*args_), 3),
               "library_us": _events_us(torch, library, 5),
               "bound_us": 1e6 * nbytes / 3.35e12}
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
