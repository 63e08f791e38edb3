"""chip_smoke.py's kernel phases alone, on the card, for one checkout.

    python3 sesameai_tts_tpu_torch/csrc/probes/kernel_phases.py [CHECKOUT] [q4] [flash] [qmm]

CHECKOUT (default: this repository) is a directory holding chip_smoke.py
and the package, for example a ``git archive`` of another commit unpacked
under ``build/``: its kernels are built from its own sources and timed by
its own phases, with this repository's attention cases, so that two
commits run in one call measure the same shapes on the same card.  Prints
one line per case (device µs per call by CUDA-graph replay, the library
call, the bound, the eager time) and the per-decoded-frame sums.  Needs a
card; not part of the package's build or tests.
"""
import importlib.util
import json
import os
import sys

here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
args = sys.argv[1:]
root = os.path.abspath(args.pop(0)) if args and os.path.isdir(args[0]) else here
which = args or ["q4", "flash"]
sys.path.insert(0, root)
spec = importlib.util.spec_from_file_location("chip_smoke_here", os.path.join(here, "chip_smoke.py"))
cs_here = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs_here)
import torch  # noqa: E402
import chip_smoke as cs  # noqa: E402  (the checkout's)
from sesameai_tts_tpu_torch.ops import attention, kernels, quant  # noqa: E402

assert os.path.abspath(quant.__file__).startswith(root)
cs._ATTN_CASES = cs_here._ATTN_CASES
name, card = cs.phase_device(torch)
bw, fl = cs._peaks(name)
kernels.build_kernels(force=True)
print("checkout", root, "build s", json.dumps(kernels.build_seconds))
per = {n: k for n, D, F, k in cs._FLAGSHIP_SHAPES}
if "q4" in which:
    rows = cs.phase_quant4_matmul(torch, quant, bw, fl)
    for r in rows:
        print("Q4 %-16s G=%-3d S=%-2d cl=%s bl=%s kernel %.3f us  lib %.3f  bound %.3f  eager %.3f" % (
            r["shape"], r["G"], r["S"], r.get("cluster"), r.get("blocks"), r["kernel_ms"] * 1e3,
            r["library_ms"] * 1e3, r["bound_ms"] * 1e3, r["kernel_eager_ms"] * 1e3))
    m = [r for r in rows if r["S"] == 1 and r["G"] == 2]
    print("Q4 per frame ms: kernel %.4f lib %.4f bound %.4f plain %.4f" % tuple(
        sum(r[k] * per[r["shape"]] for r in m)
        for k in ("kernel_ms", "library_ms", "bound_ms", "plain_ms")))
if "qmm" in which:
    rows = cs.phase_quant_matmul(torch, quant, bw, fl)
    m = [r for r in rows if r["S"] == 1]
    print("QMM per frame ms: kernel %.4f lib %.4f" % tuple(
        sum(r[k] * per[r["shape"]] for r in m) for k in ("kernel_ms", "library_ms")))
if "flash" in which:
    for r in cs.phase_flash_attention(torch, attention, bw, fl):
        print("FA %-42s kernel %.3f us  lib %s  bound %.3f  eager %.3f" % (
            r["shape"], r["kernel_ms"] * 1e3,
            "%.3f" % (r["library_ms"] * 1e3) if r["library_ms"] is not None else "-",
            r["bound_ms"] * 1e3, r["kernel_eager_ms"] * 1e3))
print(card)
