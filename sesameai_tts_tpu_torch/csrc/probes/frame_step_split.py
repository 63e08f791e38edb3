"""One graphed frame-step of a checkout's port at B rows: device ms by CUDA
events and, under the profiler, its kernels and device time split by kind
(``chip_smoke.py``'s ``_KINDS``, read from this checkout).

CSM-1B at full width, random weights from seed 0, int4 or int8 trunks; the
backbone cache filled to 600 rows; per-row temperature 0.8 and topk 40 with
one row in 8 greedy, as the benchmark's cells sample.  For each B it
captures the Generator's sampled ``backbone`` and ``sample`` graphs and
replays them back to back.  Give another checkout (a parent unpacked with
``git archive``) to measure its port with this checkout's split:

    python3 sesameai_tts_tpu_torch/csrc/probes/frame_step_split.py [checkout] \\
        [--quantize int4|int8] [--rows 1 16]

Prints one JSON line per B.
"""

import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", ".."))
FRAMES, PROFILED, CACHE_ROWS = 16, 4, 600


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("checkout", nargs="?", default=HERE)
    ap.add_argument("--quantize", default="int4", choices=("int4", "int8"))
    ap.add_argument("--rows", type=int, nargs="+", default=[1, 16])
    args = ap.parse_args()
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    sys.path.insert(0, os.path.abspath(args.checkout))

    import torch
    from torch.profiler import ProfilerActivity, profile

    from sesameai_tts_tpu_torch.models import csm
    from sesameai_tts_tpu_torch.runtime.loader import build_generator, csm_1b_spec

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = build_generator(csm_1b_spec(quantize=args.quantize), device="cuda")
    for B in args.rows:
        gen._capture(B, False, ("backbone", "sample"))
        backbone, sample = gen._graphs[(B, "backbone", False)], gen._graphs[(B, "sample", False)]
        state, bufs = gen._slot(B)

        def frames(n=FRAMES):
            for _ in range(n):
                backbone.replay()
                sample.replay()

        with gen._request():
            topk = torch.full((B,), 40, dtype=torch.int64, device="cuda")
            topk[7::8] = 1
            csm.set_sampling(bufs, torch.full((B,), 0.8, device="cuda"), topk)
            state.pos.fill_(CACHE_ROWS)
            frames()
            state.pos.fill_(CACHE_ROWS)
            torch.cuda.synchronize()
            ms = cs._events_ms(torch, frames) / FRAMES
            state.pos.fill_(CACHE_ROWS)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                frames(PROFILED)
                torch.cuda.synchronize()
            csm.load_state(state)
        kernels = cs._device_kernels(torch, prof)
        print(json.dumps({
            "checkout": os.path.abspath(args.checkout), "quantize": args.quantize, "rows": B,
            "cache_rows": CACHE_ROWS, "device_ms_per_frame_step_events": ms,
            "kernels_per_frame_step": sum(e.count for e in kernels) / PROFILED,
            "kernel_ms_per_frame_step": sum(cs._dev_us(e) for e in kernels) / 1e3 / PROFILED,
            "split_per_frame_step": cs._split(kernels, PROFILED)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
