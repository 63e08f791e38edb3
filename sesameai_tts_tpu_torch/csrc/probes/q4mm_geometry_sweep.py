"""quant4_matmul's launch geometries at S = 1, timed on the card.

    python3 sesameai_tts_tpu_torch/csrc/probes/q4mm_geometry_sweep.py [OUT_JSON]

For each flagship shape of chip_smoke.py (at G = 2, and at G = D/128 for
three of them) it launches the kernel at every (tpr, splits) whose grid
holds between half a block and four blocks per SM, checks each against
quant4_matmul_plain, and times it by CUDA-graph replay with the weight
cycled past L2.  Prints the current geometry and the four fastest per
shape, and writes every row to OUT_JSON when one is given.  This is the
measurement behind ops/quant.py::_q4mm_geometry's aim.  Needs a card; not
part of the package's build or tests.
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

t0 = time.time()
name, card = cs.phase_device(torch)
kernels.build_kernels(force=True)
sms = quant._sms(torch.device("cuda"))
gen = torch.Generator(device="cuda").manual_seed(1)
geometry = quant._q4mm_geometry
results = {}
for sname, D, F, per_frame in cs._FLAGSHIP_SHAPES:
    for G in sorted({2, D // 128}):
        if G != 2 and sname not in ("backbone.w13", "decoder.w2", "decoder.o_proj"):
            continue
        q4 = torch.randint(-128, 128, (D // 2, F), generator=gen, device="cuda", dtype=torch.int8)
        scale = torch.rand((G, F), generator=gen, device="cuda") * 1e-2 + 1e-3
        copies = cs._copies(D * F // 2)
        q4s = [q4] + [q4.clone() for _ in range(copies - 1)]
        x = torch.randn((1, D), generator=gen, device="cuda").to(torch.bfloat16)
        want = quant.quant4_matmul_plain(x, q4, scale).float()
        tol = 1e-2 * want.abs() + 1e-3 * want.abs().max()
        current = geometry(D, F, G, sms)
        D2 = D // 2
        rows_out, seen = [], set()
        for tpr in (16, 8, 4, 2, 1):
            tiles = math.ceil(F / (16 * tpr))
            for want_splits in (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16):
                rows = math.ceil(math.ceil(D2 / want_splits) / 8) * 8
                splits = math.ceil(D2 / rows)
                blocks = splits * tiles
                geo = (16, tpr, splits, rows)
                if rows < 32 or blocks > 4 * sms or blocks < sms // 2 or geo in seen:
                    continue
                seen.add(geo)
                quant._q4mm_geometry = lambda *a, geo=geo: geo
                got = quant.quant4_matmul(x, q4, scale).float()
                torch.cuda.synchronize()
                ok = bool(((got - want).abs() <= tol).all())
                us = cs._device_ms(torch, lambda i: quant.quant4_matmul(x, q4s[i % copies], scale),
                                   max(copies, 20)) * 1e3
                rows_out.append({"tpr": tpr, "splits": splits, "rows": rows, "blocks": blocks,
                                 "us": round(us, 3), "ok": ok, "current": geo == current})
        quant._q4mm_geometry = geometry
        rows_out.sort(key=lambda r: r["us"])
        now = [r for r in rows_out if r["current"]]
        results[f"{sname} G={G}"] = rows_out
        print(f"{sname:16s} G={G:<3d} current {now[0] if now else current} | best "
              + json.dumps(rows_out[:4]), flush=True)
        del q4s, q4
        torch.cuda.empty_cache()
if len(sys.argv) > 1:
    with open(sys.argv[1], "w") as f:
        json.dump(results, f, indent=1)
print(card, "sweep s", round(time.time() - t0, 1))
