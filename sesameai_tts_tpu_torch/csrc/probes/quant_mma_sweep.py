"""The tensor-core route's launch plans, timed on the card.

    python3 sesameai_tts_tpu_torch/csrc/probes/quant_mma_sweep.py [OUT_JSON]

For quant_matmul (the flagship shapes, and the tp = 2 backbone shards at
S = 64) and quant4_matmul (the flagship shapes at G = 2), at S = 2, 8 and
64, it launches the tensor-core kernel at every instantiated (mt, nt, wk, wn)
whose n-tiles are the fewest that hold S rows, and at every cluster size
from 1 to 16 that gives distinct splits, checks each against the plain
version, and times it by CUDA-graph replay with the weight cycled past L2
(chip_smoke.py's ``_device_ms``).  Prints, per shape and S, torch.matmul's
time, the current plan's and the four fastest, and writes every row to
OUT_JSON when one is given.  This is the measurement behind
ops/quant.py::_mma_plan.  Needs a card; not part of the package's build or
tests.
"""
import json
import math
import os
import sys
import time

here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
sys.path.insert(0, here)
import torch  # noqa: E402
import chip_smoke as cs  # noqa: E402
from sesameai_tts_tpu_torch.ops import kernels, quant  # noqa: E402

# the kernels' (mt, nt, wk, wn) instantiations (quant_matmul.cu, quant4_matmul.cu)
TILES = {
    "quant_matmul": [(4, 1, 4, 1), (8, 2, 4, 1), (4, 2, 4, 1), (4, 4, 2, 1), (2, 8, 1, 1)],
    "quant4_matmul": [(4, 1, 4, 1), (4, 2, 4, 1), (2, 4, 2, 1), (2, 8, 1, 2)],
}
SPLITS = (1, 2, 3, 4, 5, 6, 8, 11, 16)

t0 = time.time()
name, card = cs.phase_device(torch)
kernels.build_kernels(force=True)
sms = quant._sms(torch.device("cuda"))
gen = torch.Generator(device="cuda").manual_seed(2)
results = {}
for kname in ("quant_matmul", "quant4_matmul"):
    int4 = kname == "quant4_matmul"
    plan_of = quant._q4mm_mma_plan if int4 else quant._qmm_mma_plan
    attr = "_q4mm_mma_plan" if int4 else "_qmm_mma_plan"
    smem_of = quant._q4mm_mma_smem if int4 else quant._qmm_mma_smem
    cases = [(n, D, F, s) for n, D, F, _ in cs._FLAGSHIP_SHAPES for s in (2, 8, 64)]
    if not int4:
        cases += [(n, D, F, 64) for n, D, F, _ in cs._TP2_SHAPES if n.startswith("backbone")]
    for sname, D, F, S in cases:
        if int4:
            w = torch.randint(-128, 128, (D // 2, F), generator=gen, device="cuda",
                              dtype=torch.int8)
            scale = torch.rand((2, F), generator=gen, device="cuda") * 1e-2 + 1e-3
            dense = quant._dequant4({"q4": w, "scale": scale})
            call, plain = quant.quant4_matmul, quant.quant4_matmul_plain
        else:
            w = torch.randint(-127, 128, (D, F), generator=gen, device="cuda", dtype=torch.int8)
            scale = torch.rand(F, generator=gen, device="cuda") * 1e-2 + 1e-3
            dense = quant._dequant({"q": w, "scale": scale})
            call, plain = quant.quant_matmul, quant.quant_matmul_plain
        copies = cs._copies(w.numel())
        ws = [w] + [w.clone() for _ in range(copies - 1)]
        denses = [dense] + [dense.clone() for _ in range(cs._copies(dense.numel() * 2) - 1)]
        x = torch.randn((S, D), generator=gen, device="cuda").to(torch.bfloat16)
        want = plain(x, w, scale).float()
        tol = 1e-2 * want.abs() + 1e-3 * want.abs().max()
        reps = max(copies, 20)
        lib_us = cs._device_ms(torch, lambda i: torch.matmul(x, denses[i % len(denses)]),
                               reps) * 1e3
        rows_d = D // 2 if int4 else D
        current = plan_of(S, D, F, 2, sms) if int4 else plan_of(S, D, F, sms)
        out, seen = [], set()
        for mt, nt, wk, wn in TILES[kname]:
            if nt != current.nt or F % (2 * mt):
                continue
            for want_splits in SPLITS:
                rows = math.ceil(math.ceil(rows_d / want_splits) / 16) * 16
                splits = math.ceil(rows_d / rows)
                plan = quant._MmaPlan(mt, nt, wk, wn, splits, rows,
                                      smem_of(S, mt, nt, wk, splits))
                if plan in seen or plan.smem > quant._MAX_SMEM:
                    continue
                seen.add(plan)
                setattr(quant, attr, lambda *a, plan=plan: plan)
                try:
                    got = call(x, w, scale).float()
                    torch.cuda.synchronize()
                    ok = bool(((got - want).abs() <= tol).all())
                    us = cs._device_ms(torch, lambda i: call(x, ws[i % copies], scale), reps) * 1e3
                finally:
                    setattr(quant, attr, plan_of)
                out.append({"mt": mt, "nt": nt, "wk": wk, "wn": wn, "splits": splits, "rows": rows,
                            "blocks": splits * math.ceil(F / plan.cols), "smem": plan.smem,
                            "us": round(us, 3), "ok": ok, "current": plan == current})
        out.sort(key=lambda r: r["us"])
        now = [r for r in out if r["current"]]
        results[f"{kname} {sname} S={S}"] = {"lib_us": lib_us, "rows": out}
        print(f"{kname:13s} {sname:16s} S={S:<2d} lib {lib_us:.3f} | current "
              f"{json.dumps(now[0] if now else None)} | best {json.dumps(out[:4])}", flush=True)
        if not all(r["ok"] for r in out):
            print("  DISAGREES: " + json.dumps([r for r in out if not r["ok"]]), flush=True)
        del ws, denses, w, dense
        torch.cuda.empty_cache()
if len(sys.argv) > 1:
    with open(sys.argv[1], "w") as f:
        json.dump(results, f, indent=1)
print(card, "sweep s", round(time.time() - t0, 1))
