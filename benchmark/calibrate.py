"""Read the comparison's numbers over many seeds in one process, for the
program and for its controls, to set a cell's limits from.

    python3 benchmark/calibrate.py --workload <cell> --seeds 101 102 ... --seconds <s>
        [--program-lower] [--controls] [--fault topk-off]

Each seed is a whole run of the cell as ``run.py`` makes it (set-up,
window, comparison), printed as one JSON line: the readings, and the
end-to-end metrics.  ``--program-lower`` runs the program at the next
lower precision it has (int8 trunks → int4) against the reference at the
configuration's own: that control has to come out not correct.
``--controls`` also reads, at the same positions, the gap of the token a
reference one step lower puts first (int8 → int4, int4 → int3) and the
PCM of a Mimi with fp8 weights, and puts each in the program's place
before the verdict (``controls``: whether each would pass; neither may).
``--fault topk-off`` has the started pool sample its ticks' sampled rows
from the whole vocabulary (the top-k filter left out), the fault that
``topk_gap`` is there to catch.  Not part of the benchmark's runs.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import run as bench_run  # noqa: E402
from benchmark.harness import specs  # noqa: E402

PROGRAM_LOWER = {"int8": "int4"}


def topk_off(server) -> None:
    """Every sampled slot attached from now on samples from all codes."""
    attach = server._attach_state
    vocab = server.gen._cfg.audio_vocab_size

    def wide(slot, frame, state1, temperature, topk):
        return attach(slot, frame, state1, temperature, topk if topk <= 1 else vocab)

    server._attach_state = wide


FAULTS = {"topk-off": topk_off}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--program-lower", action="store_true")
    p.add_argument("--controls", action="store_true")
    p.add_argument("--fault", choices=sorted(FAULTS))
    args = p.parse_args(argv)
    cell = specs.load_cell(args.workload)
    name, power = bench_run._card(cell.chips)
    quantize = "config"
    if args.program_lower:
        quantize = PROGRAM_LOWER.get(cell.config.get("quantize"))
        if quantize is None:
            print(f"the program has no path below {cell.config.get('quantize')}", file=sys.stderr)
            return 2
    for seed in args.seeds:
        out = bench_run.run_cell(cell, seed, args.seconds, False, quantize=quantize,
                                 control=args.controls, t_start=time.perf_counter(),
                                 fault=FAULTS.get(args.fault))
        run = out["run"]
        run.device_name = name
        line = {"seed": seed, "program": quantize, "fault": args.fault, "correct": out["ok"],
                "controls_correct": out["controls"],
                "attempted": out["attempted"], "failed": out["failed"],
                "readings": out["readings"],
                "metrics": {k: v["value"] for k, v in bench_run.metrics_of(run, False).items()},
                "peak": run.peak, "card": name, "power_limit_w": power}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
