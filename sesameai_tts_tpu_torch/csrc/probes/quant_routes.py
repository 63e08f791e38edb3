"""quant_matmul and quant4_matmul (or quant_mlp) by S, for one or more
checkouts, on the card.

    python3 sesameai_tts_tpu_torch/csrc/probes/quant_routes.py [--mlp] [CHECKOUT ...]

Each CHECKOUT (default: this repository) is a directory holding
chip_smoke.py and the package, for example a ``git archive`` of another
commit unpacked under ``build/``.  Each runs in a process of its own: its
kernels are built from its own sources and timed by its own kernel phases
(``phase_quant_matmul`` and ``phase_quant4_matmul`` at the flagship shapes
and S values, G = 2 for int4, and ``phase_quant_matmul`` at the tp = 2
shard shapes).  For every S it prints the sums over one decoded frame's
launches (at S = B, a frame-step of a B-slot pool) of the kernel's device
time, ``torch.matmul``'s on the dequantized weight, the bound and the plain
version's, in ms, and the tp = 2 backbone shapes' sum per call at S = 64
(a mesh prompt's prefill).  With ``--mlp`` it runs ``phase_quant_mlp``
instead, at the flagship MLPs and S values and at the tp = 2 shards, and
adds the port's unfused int8 pair (``unfused_ms``) to the sums.  Give the
checkouts in turns (parent, change, change, parent) to compare two commits
on one card in one call.  Needs a card; not part of the package's build or
tests.
"""
import json
import os
import subprocess
import sys

_KEYS = ("kernel_ms", "library_ms", "bound_ms", "plain_ms")


def _by_s(rows, per_frame=True, keys=_KEYS):
    return {S: {k: sum(r[k] * (r["per_frame"] if per_frame else 1)
                       for r in rows if r["S"] == S) for k in keys}
            for S in sorted({r["S"] for r in rows})}


def one_mlp(root: str) -> None:
    sys.path.insert(0, root)
    import torch
    import chip_smoke as cs
    from sesameai_tts_tpu_torch.ops import kernels, quant

    assert os.path.abspath(quant.__file__).startswith(os.path.abspath(root) + os.sep)
    name, card = cs.phase_device(torch)
    bw, fl = cs._peaks(name)
    kernels.build_kernels(force=True)
    keys = _KEYS + ("unfused_ms",)
    rows = cs.phase_quant_mlp(torch, quant, bw, fl)
    tp2 = cs.phase_quant_mlp(torch, quant, bw, fl, cs._TP2_MLP_SHAPES, cs._TP2_S_VALUES)
    out = {"checkout": root, "card": card, "build_s": kernels.build_seconds,
           "quant_mlp per frame": _by_s(rows, keys=keys),
           "quant_mlp tp2 per frame": _by_s(tp2, keys=keys),
           "quant_mlp per call": {r["shape"] + f" S={r['S']}": r["kernel_ms"]
                                  for r in rows + tp2}}
    print("ROUTES " + json.dumps(out), flush=True)


def one(root: str) -> None:
    sys.path.insert(0, root)
    import torch
    import chip_smoke as cs
    from sesameai_tts_tpu_torch.ops import kernels, quant

    assert os.path.abspath(quant.__file__).startswith(os.path.abspath(root) + os.sep)
    name, card = cs.phase_device(torch)
    bw, fl = cs._peaks(name)
    kernels.build_kernels(force=True)
    int8 = cs.phase_quant_matmul(torch, quant, bw, fl)
    int4 = [r for r in cs.phase_quant4_matmul(torch, quant, bw, fl) if r["G"] == 2]
    tp2 = cs.phase_quant_matmul(torch, quant, bw, fl, cs._TP2_SHAPES, cs._TP2_S_VALUES)
    out = {"checkout": root, "card": card, "build_s": kernels.build_seconds,
           "quant_matmul per frame": _by_s(int8), "quant4_matmul per frame": _by_s(int4),
           "quant_matmul tp2 per frame": _by_s(tp2),
           "quant_matmul tp2 backbone per call":
               _by_s([r for r in tp2 if r["shape"].startswith("backbone")], per_frame=False)}
    print("ROUTES " + json.dumps(out), flush=True)


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] in ("--one", "--one-mlp"):
        (one_mlp if sys.argv[1] == "--one-mlp" else one)(sys.argv[2])
        sys.exit(0)
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    mlp = "--mlp" in sys.argv[1:]
    failed = 0
    for checkout in [a for a in sys.argv[1:] if a != "--mlp"] or [here]:
        run = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one-mlp" if mlp else "--one", os.path.abspath(checkout)],
                             cwd=checkout, capture_output=True, text=True)
        lines = run.stdout.splitlines()
        print("\n".join(line for line in lines if line.startswith("ROUTES ")
                        or "kernel quant" in line and ('"ok": false' in line
                                                       or '"bit_equal_repeat_and_replay": false'
                                                       in line)), flush=True)
        if run.returncode != 0:
            failed += 1
            print(f"{checkout}: exit {run.returncode}\n{run.stderr[-4000:]}", flush=True)
    sys.exit(1 if failed else 0)
