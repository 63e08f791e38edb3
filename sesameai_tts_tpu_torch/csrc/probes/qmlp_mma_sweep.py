"""quant_mlp's tensor-core launch plans, timed on the card.

    python3 sesameai_tts_tpu_torch/csrc/probes/qmlp_mma_sweep.py [OUT_JSON]

At the flagship MLPs (backbone and decoder) and one rank's tp = 2 shards,
at S = 2, 8 and 64, it launches quant_mlp's tensor-core route at every
intermediate tile (block_i: the grid of F / block_i blocks, one an SM),
every phase-2 column tile (the chunk of Dout a block's w2 partial covers;
the splits of F follow from the grid), and with ring stages of half the
rows, checks each against the plain
version, and times it by CUDA-graph replay with the weights cycled past L2
(chip_smoke.py's ``_device_ms``).  Prints, per shape and S, the dense bf16
sequence's time, the current plan's and the four fastest, and writes every
row to OUT_JSON when one is given.  This is the measurement behind
ops/quant.py::_qmlp_mma_plan.  Needs a card; not part of the package's
build or tests.
"""
import json
import os
import sys
import time

here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
sys.path.insert(0, here)
import torch  # noqa: E402
import chip_smoke as cs  # noqa: E402
from sesameai_tts_tpu_torch.ops import kernels, quant  # noqa: E402

TILES = (32, 64, 128, 256)
COLS = (64, 128)

t0 = time.time()
name, card = cs.phase_device(torch)
kernels.build_kernels(force=True)
sms = quant._sms(torch.device("cuda"))
gen = torch.Generator(device="cuda").manual_seed(2)
F_ = torch.nn.functional
plan_of = quant._qmlp_mma_plan
results = {}
for sname, D, F, Dout, _ in cs._MLP_SHAPES + cs._TP2_MLP_SHAPES:
    q13 = torch.randint(-127, 128, (D, 2 * F), generator=gen, device="cuda", dtype=torch.int8)
    q2 = torch.randint(-127, 128, (F, Dout), generator=gen, device="cuda", dtype=torch.int8)
    s13 = torch.rand(2 * F, generator=gen, device="cuda") * 1e-3 + 1e-4
    s2 = torch.rand(Dout, generator=gen, device="cuda") * 1e-2 + 1e-3
    copies = cs._copies(2 * D * F + F * Dout)
    mats = [(q13, q2)] + [(q13.clone(), q2.clone()) for _ in range(copies - 1)]
    w13 = quant._dequant({"q": q13, "scale": s13})
    w1, w3, w2 = w13[:, :F].contiguous(), w13[:, F:].contiguous(), quant._dequant({"q": q2,
                                                                                  "scale": s2})
    del w13
    reps = max(copies, 20)
    for S in (2, 8, 64):
        x = torch.randn((S, D), generator=gen, device="cuda").to(torch.bfloat16)
        want = quant.quant_mlp_plain(x, q13, s13, q2, s2).float()
        tol = 1e-2 * want.abs() + 1e-3 * want.abs().max()
        dense_us = cs._device_ms(torch, lambda i: torch.matmul(
            F_.silu(torch.matmul(x, w1)) * torch.matmul(x, w3), w2), reps) * 1e3
        current = plan_of(S, D, F, Dout, sms)
        out, seen = [], set()
        for block_i in TILES:
            if F % block_i or F // block_i > sms:
                continue
            for cols in COLS:
                try:
                    base = plan_of(S, D, F, Dout, sms, block_i=block_i, cols=cols)
                except ValueError:
                    continue
                for kc1, kc2 in ((base.kc1, base.kc2), (base.kc1 // 2, base.kc2 // 2)):
                    if kc1 % (16 * base.wk1) or kc2 % (16 * base.wk2):
                        continue
                    plan = base._replace(kc1=kc1, kc2=kc2)
                    if plan in seen:
                        continue
                    seen.add(plan)
                    quant._qmlp_mma_plan = lambda *a, plan=plan, **k: plan
                    try:
                        got = quant.quant_mlp(x, q13, s13, q2, s2).float()
                        torch.cuda.synchronize()
                        ok = bool(((got - want).abs() <= tol).all())
                        us = cs._device_ms(torch, lambda i: quant.quant_mlp(
                            x, mats[i % copies][0], s13, mats[i % copies][1], s2), reps) * 1e3
                    except RuntimeError as e:  # refused by the launch
                        print(f"  refused {plan}: {e}", flush=True)
                        continue
                    finally:
                        quant._qmlp_mma_plan = plan_of
                    out.append({**plan._asdict(), "blocks": F // block_i, "us": round(us, 3),
                                "ok": ok, "current": plan == current})
        out.sort(key=lambda r: r["us"])
        now = [r for r in out if r["current"]]
        results[f"{sname} S={S}"] = {"dense_us": dense_us, "rows": out}
        print(f"quant_mlp {sname:17s} S={S:<2d} dense {dense_us:.3f} | current "
              f"{json.dumps(now[0] if now else None)} | best {json.dumps(out[:4])}", flush=True)
        if not all(r["ok"] for r in out):
            print("  DISAGREES: " + json.dumps([r for r in out if not r["ok"]]), flush=True)
    del mats, w1, w3, w2, q13, q2
    torch.cuda.empty_cache()
if len(sys.argv) > 1:
    with open(sys.argv[1], "w") as f:
        json.dump(results, f, indent=1)
print(card, "sweep s", round(time.time() - t0, 1))
