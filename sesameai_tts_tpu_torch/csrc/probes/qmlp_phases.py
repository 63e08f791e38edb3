"""quant_mlp split by phase on the card, for one checkout.

    python3 sesameai_tts_tpu_torch/csrc/probes/qmlp_phases.py [CHECKOUT] [window]

CHECKOUT (default: this repository) is a directory holding the package,
for example a ``git archive`` of another commit unpacked under ``build/``:
its kernels are built from its own sources, so that two commits run in
one call measure the same shapes on the same card.  For each decode-time
MLP of chip_smoke.py at S = 1, 8 and 64 it prints, in µs per call:

- ``call``: one quant_mlp call, by CUDA-graph replay with the weights
  cycled past the 50 MB L2 (chip_smoke.py's timing);
- ``by kernel``: device time per launch of each CUDA kernel the call
  runs, from torch.profiler over eager calls (a design of two kernels,
  a tile pass and a reduce, shows both);
- ``w13 only``: the same call with a w2 of 8 output columns, whose bytes
  and reduction are negligible: the w13 stream and the fixed costs.
  ``call - w13 only`` is what w2 and its reduction add;
- ``fixed``: a call with D = 16 and a w2 of 8 columns at the same F and S:
  the launch, the barriers and the reductions without weight bytes.

and the per-decoded-frame sums at S = 1 (16 backbone and 128 decoder
MLPs).  With ``window`` it profiles instead the fused configuration's
window of chip_smoke.py (prefill + 4 decoded frames, CSM-1B, device
activity only) and prints its kernel launches: all, those of the
quant_mlp kernels (``qmlp_`` names) and the rest, so that two checkouts
show which kernels a change removed.  Needs a card; not part of the
package's build or tests.
"""
import json
import os
import sys

here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
args = sys.argv[1:]
root = os.path.abspath(args.pop(0)) if args and os.path.isdir(args[0]) else here
window = "window" in args
sys.path.insert(0, root)
import importlib.util  # noqa: E402

spec = importlib.util.spec_from_file_location("chip_smoke_here", os.path.join(here, "chip_smoke.py"))
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402
from sesameai_tts_tpu_torch.ops import kernels, quant  # noqa: E402

assert os.path.abspath(quant.__file__).startswith(root)
name, card = cs.phase_device(torch)
kernels.build_kernels(force=True)
print("checkout", root, "build s", json.dumps(kernels.build_seconds), flush=True)
gen = torch.Generator(device="cuda").manual_seed(2)

if window:
    from sesameai_tts_tpu_torch.runtime.loader import build_generator, csm_1b_spec

    tts = build_generator(csm_1b_spec(fused_mlp=True), device="cuda")
    tts.generate("warm up", 0, [], max_audio_length_ms=240, temperature=0.8, topk=40, seed=7)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tts.generate_frames(cs.TEXT_2, 0, [], max_audio_length_ms=400, temperature=0.8, topk=40,
                            seed=2)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    counts = {}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) == cuda:
            counts[e.key] = counts.get(e.key, 0) + e.count
    mlp = {k[:60]: n for k, n in counts.items() if "qmlp_" in k}
    total = sum(counts.values())
    print("WINDOW " + json.dumps({"kernel_launches": total, "qmlp": mlp,
                                  "other": total - sum(mlp.values())}), flush=True)
    print(card)
    sys.exit(0)


def weights(D, F, Dout):
    q13 = torch.randint(-127, 128, (D, 2 * F), generator=gen, device="cuda", dtype=torch.int8)
    q2 = torch.randint(-127, 128, (F, Dout), generator=gen, device="cuda", dtype=torch.int8)
    s13 = torch.rand(2 * F, generator=gen, device="cuda") * 1e-3 + 1e-4
    s2 = torch.rand(Dout, generator=gen, device="cuda") * 1e-2 + 1e-3
    copies = cs._copies(2 * D * F + F * Dout)
    return [(q13, q2)] + [(q13.clone(), q2.clone()) for _ in range(copies - 1)], s13, s2


def by_kernel(fn, copies):
    fn(0)
    torch.cuda.synchronize()
    n = max(copies, 20)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            fn(i)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    out = {}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != cuda or not e.count:
            continue
        us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        out[e.key[:60]] = round(us / e.count, 3)
    return out


per_frame = {}
for sname, D, F, Dout, n_frame in cs._MLP_SHAPES:
    mats, s13, s2 = weights(D, F, Dout)
    narrow, _, s2n = weights(D, F, 8)
    tiny, s13t, _ = weights(16, F, 8)
    copies, copies_n = len(mats), len(narrow)
    for S in cs._S_VALUES:
        x = torch.randn((S, D), generator=gen, device="cuda").to(torch.bfloat16)

        def call(i):
            return quant.quant_mlp(x, mats[i % copies][0], s13, mats[i % copies][1], s2)

        def w13_only(i):
            return quant.quant_mlp(x, narrow[i % copies_n][0], s13, narrow[i % copies_n][1], s2n)

        xt = x[:, :16].contiguous()

        def fixed(i):
            return quant.quant_mlp(xt, tiny[0][0], s13t, tiny[0][1], s2n)

        row = {"shape": sname, "S": S,
               "call_us": cs._device_ms(torch, call, max(copies, 20)) * 1e3,
               "w13_only_us": cs._device_ms(torch, w13_only, max(copies_n, 20)) * 1e3,
               "fixed_us": cs._device_ms(torch, fixed, 20) * 1e3,
               "by_kernel_us": by_kernel(call, copies)}
        row["w2_and_reduce_us"] = row["call_us"] - row["w13_only_us"]
        print("QMLP " + json.dumps(row), flush=True)
        if S == 1:
            for k in ("call_us", "w13_only_us", "w2_and_reduce_us", "fixed_us"):
                per_frame[k] = per_frame.get(k, 0.0) + row[k] * n_frame / 1e3
            for k, us in row["by_kernel_us"].items():
                per_frame[k] = per_frame.get(k, 0.0) + us * n_frame / 1e3
    del mats, narrow, tiny
    torch.cuda.empty_cache()
print("QMLP per decoded frame (ms) " + json.dumps(per_frame), flush=True)
print(card)
