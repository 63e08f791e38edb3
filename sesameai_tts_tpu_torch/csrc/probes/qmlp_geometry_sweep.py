"""quant_mlp's launch geometries at S = 1, timed on the card.

    python3 sesameai_tts_tpu_torch/csrc/probes/qmlp_geometry_sweep.py [OUT_JSON]

For the backbone's and the decoder's MLP of chip_smoke.py it launches the
kernel at every (block_i, threads, blocks per SM, cluster) that the card
takes in one wave (the launch refuses the others), checks each against
quant_mlp_plain, and times it by CUDA-graph replay with the weights cycled
past L2.  Blocks per SM are set through the shared memory asked for, as
ops/quant.py::_qmlp_geometry does.  Prints the current geometry and the
four fastest per shape, and writes every row to OUT_JSON when one is
given.  This is the measurement behind _qmlp_geometry's constants.  Needs
a card; not part of the package's build or tests.
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

t0 = time.time()
name, card = cs.phase_device(torch)
kernels.build_kernels(force=True)
sms = quant._sms(torch.device("cuda"))
gen = torch.Generator(device="cuda").manual_seed(2)
geometry = quant._qmlp_geometry
results = {}
for sname, D, F, Dout, per_frame in cs._MLP_SHAPES:
    q13 = torch.randint(-127, 128, (D, 2 * F), generator=gen, device="cuda", dtype=torch.int8)
    q2 = torch.randint(-127, 128, (F, Dout), generator=gen, device="cuda", dtype=torch.int8)
    s13 = torch.rand(2 * F, generator=gen, device="cuda") * 1e-3 + 1e-4
    s2 = torch.rand(Dout, generator=gen, device="cuda") * 1e-2 + 1e-3
    copies = cs._copies(2 * D * F + F * Dout)
    mats = [(q13, q2)] + [(q13.clone(), q2.clone()) for _ in range(copies - 1)]
    x = (torch.randn((1, D), generator=gen, device="cuda") * 0.3).to(torch.bfloat16)
    want = quant.quant_mlp_plain(x, q13, s13, q2, s2).float()
    tol = 1e-2 * want.abs() + 1e-3 * want.abs().max()
    current = geometry(1, D, F, Dout, sms)
    rows_out = []
    for block_i in (64, 32):
        blocks = F // block_i
        for per_sm in (1, 2):
            for threads in (128, 256, 512):
                if threads * per_sm > 512 or threads % (2 * block_i // 16):
                    continue
                budget = quant._QMLP_SM_SMEM // per_sm - quant._QMLP_BLOCK_RESERVED
                spread = quant._QMLP_SM_SMEM // (per_sm + 1) - quant._QMLP_BLOCK_RESERVED + 16
                for cluster in (1, 2, 4, 8, 16):
                    if blocks % cluster:
                        continue
                    need = quant._qmlp_smem_bytes(1, block_i, Dout, threads, cluster, block_i)
                    smem = min(quant._QMLP_MAX_SMEM, budget, max(need, spread))
                    if need > smem:
                        continue
                    geo = (block_i, cluster, threads, block_i, smem, 1)
                    quant._qmlp_geometry = lambda *a, geo=geo: geo
                    try:
                        got = quant.quant_mlp(x, q13, s13, q2, s2).float()
                    except RuntimeError:  # refused: not one wave
                        continue
                    torch.cuda.synchronize()
                    ok = bool(((got - want).abs() <= tol).all())
                    us = cs._device_ms(torch, lambda i: quant.quant_mlp(
                        x, mats[i % copies][0], s13, mats[i % copies][1], s2),
                        max(copies, 20)) * 1e3
                    rows_out.append({"block_i": block_i, "per_sm": per_sm, "threads": threads,
                                     "cluster": cluster, "smem": smem, "us": round(us, 3),
                                     "ok": ok, "current": geo == current})
    quant._qmlp_geometry = geometry
    rows_out.sort(key=lambda r: r["us"])
    now = [r for r in rows_out if r["current"]]
    results[sname] = rows_out
    print(f"{sname:14s} current {now[0] if now else current} | best "
          + json.dumps(rows_out[:4]), flush=True)
    print(f"{sname:14s} all " + json.dumps(rows_out), flush=True)
    del mats, q13, q2
    torch.cuda.empty_cache()
if len(sys.argv) > 1:
    with open(sys.argv[1], "w") as f:
        json.dump(results, f, indent=1)
print(card, "sweep s", round(time.time() - t0, 1))
