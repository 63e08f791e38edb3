"""Find an open-loop cell's knee: run it at several arrival rates in one
process and print, for each, the tail of the time to first audio and
whether the admission backlog grew over the window.

    python3 benchmark/sweep.py --workload <cell> --rates 3 4 5 6 --seconds <s> --seed <n>

For each rate one JSON line: the 95th percentile of the time from a
request's scheduled send to its first audio (``ttfa_p95_ms``),
``chunk_gap_p95_ms``, the requests still waiting for first audio at the
window's close (``backlog_at_close``) and the median time to first audio
of the window's first and last thirds (a growing backlog shows as a
rising one).  The knee is the highest rate whose ``ttfa_p95_ms`` and
``chunk_gap_p95_ms`` stay within their limits and whose backlog does not
grow; the cell's rate is 4/5 of it, written into its traffic file as a
number.  Give one rate a process: in one process, later runs read worse.
Not part of the benchmark's runs.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import run as bench_run  # noqa: E402
from benchmark.harness import specs, stats  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seed", type=int, required=True)
    args = p.parse_args(argv)
    cell = specs.load_cell(args.workload)
    name, power = bench_run._card(cell.chips)
    base = dict(cell.traffic)
    for rate in args.rates:
        cell.traffic = dict(base, rate_per_s=rate)
        out = bench_run.run_cell(cell, args.seed, args.seconds, False,
                                 t_start=time.perf_counter())
        run = out["run"]
        t0, t1 = run.t0, run.t1
        sent = [r for r in run.requests if stats.in_window(r.scheduled, t0, t1)]
        third = (t1 - t0) / 3

        def p50(a, b):
            w = [r.first_chunk_at() - r.scheduled for r in sent
                 if a <= r.scheduled - t0 < b and r.first_chunk_at() is not None]
            return None if not w else 1e3 * stats.percentile(w, 50)

        backlog = sum(1 for r in sent if r.first_chunk_at() is None or r.first_chunk_at() >= t1)
        m = {k: v["value"] for k, v in bench_run.metrics_of(run, False).items()}
        p95 = stats.percentile(stats.ttfa_s(run.requests, t0, t1, run.missed_s), 95)
        waits = stats.ttfa_s(run.requests, t0, t1, run.missed_s)
        print(json.dumps({"rate_per_s": rate, "seed": args.seed, "sent": len(sent),
                          "ttfa_p95_ms": 1e3 * p95,
                          "ttfa_p50_ms": 1e3 * stats.percentile(waits, 50),
                          "chunk_gap_p95_ms": m.get("chunk_gap_p95_ms"),
                          "backlog_at_close": backlog,
                          "ttfa_p50_ms_first_third": p50(0, third),
                          "ttfa_p50_ms_last_third": p50(2 * third, 3 * third),
                          "audio_s_per_s": stats.samples_in_window(run.requests, t0, t1)
                          / run.sample_rate / args.seconds,
                          "card_busy_pct": run.busy_pct, "setup_s": run.setup_s,
                          "correct": out["ok"], "card": name, "power_limit_w": power}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
