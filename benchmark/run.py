"""Run one cell of the benchmark once on the card and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Set-up (``setup_s``, from the process's
start to the window's): the weights drawn on the card from the seed, the
port's Generator and serving pool built over them (its kernels built into
the checkout's ``build/`` on the first run, loaded after), the graphs
captured, the cached voices prefilled, and the cell's shapes warmed up
by requests like its own.  Then the traffic loop sends the cell's
requests for ``--seconds``.  With ``--trace 1`` the pool's calls into
its layers are timed over the window, ``torch.profiler`` records every
kernel of its last ``trace.TRACE_S`` seconds, and the card's utilization
counter is sampled up to there (``harness/trace.py``).
After the window: the answers still due are waited for (up to
``DRAIN_S``), the pool stopped, the peak memory read, the program freed,
and the served tokens and PCM compared with the plain reference.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each compared number beside its
limit.  The same comparison ends standard error.  Without a card, or
with fewer cards than the cell asks for, it prints no result and exits 3.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import faulthandler  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import queue  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
os.environ.setdefault("USE_FLAX", "0")  # a library that would load JAX by itself does not

import numpy as np  # noqa: E402

from benchmark.harness import check, specs, stats, texts, trace, weights  # noqa: E402
from benchmark.harness.client import Sender  # noqa: E402

DRAIN_S = 60.0  # how long the answers due at the window's close are waited for


class Run:
    """What a cell's run saw, for the metric readers (``metrics/``)."""

    def __init__(self, cell, seconds: float):
        self.cell = cell
        self.config = cell.config
        self.seconds = seconds
        self.t0 = self.t1 = 0.0
        self.setup_s = 0.0
        self.requests = []
        self.voices = []
        self.counters = {}
        self.trace = None  # traced runs: the profiled sub-window (harness/trace.py)
        self.frame_step_s = None  # traced runs: device seconds a frame-step
        self.busy_pct = None  # the card's utilization counter (traced: up to the sub-window)
        self.peak = None
        self.sample_rate = cell.config["mimi"]["sample_rate"]
        self.hop = check.hop(cell.config["mimi"])
        self.slots = cell.settings["slots"]
        self.missed_s = 0.0
        self.device_name = None


def _card(chips: int):
    """(name, power limit) of the card; exits 3 without enough cards."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"needs {chips} CUDA card(s), found {n}: no result", file=sys.stderr)
        sys.exit(3)
    name = torch.cuda.get_device_name(0)
    limit = None
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30)
        limit = float(smi.stdout.strip().splitlines()[0])
    except Exception:
        pass
    return name, limit


class Phases:
    """Set-up's phases: seconds from the process's start to the end of
    each, printed on standard error as they end."""

    def __init__(self, t_start: float):
        self.t_start = t_start
        self.ends = {}

    def __call__(self, what: str) -> None:
        t = time.perf_counter() - self.t_start
        self.ends[what] = t
        print(f"[{t:8.2f} s] {what}", file=sys.stderr, flush=True)

    def lengths(self) -> dict:
        """Each phase's own seconds."""
        out, last = {}, 0.0
        for name, t in self.ends.items():
            out[name] = t - last
            last = t
        return out


def run_cell(cell, seed: int, seconds: float, traced: bool, device="cuda",
             quantize="config", control: bool = False, t_start: float = T_START,
             fault=None) -> dict:
    """One run of ``cell`` → the result's fields (``correct`` and the rest),
    plus ``lines`` to print before it and ``check_lines`` to end stderr.
    ``fault(server)``, when given, breaks the started pool (a check of the
    comparison, never in the benchmark's runs)."""
    import torch

    from benchmark.harness import system

    s = cell.settings
    run = Run(cell, seconds)
    phase = Phases(t_start)
    phase("python, numpy, the harness")
    on_card = torch.device(device).type == "cuda"
    if traced and on_card:
        trace.init_cupti()  # before the program captures a graph
        phase("CUPTI started")
    rng_traffic = np.random.default_rng(weights.sub_seeds(seed, 4)[3])
    mix = cell.traffic
    srv = system.build(cell.family, cell.config, cell.config_name, seed, device, s["slots"],
                       s["chunk_frames"], quantize, phase)
    run.voices = texts.make_voices(cell.config, mix["voices"], tuple(mix["voice_rows"]),
                                   rng_traffic)
    system.cache_voices(srv, run.voices)
    phase("voices prefilled")
    loop = cell.loop()
    plan = loop.plan(mix, rng_traffic, seconds, len(run.voices), cell.config)
    srv.start()
    phase("graphs captured, pool started")
    warm = system.warm(srv, cell.config, run.voices, plan)
    phase("warmed up")
    if fault is not None:
        fault(srv)
    lines = [f"warm-up {json.dumps(warm)}"]

    ended = queue.Queue()
    sender = Sender(srv, run.voices, on_end=ended.put)
    srv.metrics.reset()
    srv._admitter.metrics.reset()
    calls = gate = None
    if traced and on_card:
        calls = trace.Calls(srv)
        calls.install()
        gate = trace.Gate(srv)
    util = trace.Utilization().start() if on_card else None
    t0 = time.perf_counter()
    run.setup_s = t0 - t_start
    lines.append(f"setup {json.dumps(phase.lengths())}")
    t1 = t0 + seconds
    result = {}
    driver = threading.Thread(target=lambda: result.update(loop.drive(sender.send, plan, t0, t1,
                                                                      ended)), daemon=True)
    driver.start()
    t_util = t1
    if gate is not None:  # the window's last seconds profiled; the pool held at its close
        t_util = t1 - trace.TRACE_S
        time.sleep(max(0.0, t_util - time.perf_counter()))
        calls.close()
        run.trace = trace.sub_window(gate, calls)
    time.sleep(max(0.0, t1 - time.perf_counter()))
    phase("window closed")
    run.counters["frame_steps"] = srv.metrics.summary().get("tick_frames", {}).get("total", 0.0)
    run.counters["admission_p50_s"] = srv._admitter.metrics.summary().get(
        "prefill_s", {}).get("p50")
    if util is not None:
        util.stop()
        run.busy_pct = util.busy_pct(t0, t_util)
        seen = {"busy_pct": run.busy_pct, "to_s": t_util - t0, "samples": len(util.samples)}
        lines.append(f"utilization {json.dumps(seen)}")
    if gate is not None:
        gate.release()
    driver.join(timeout=60)
    run.t0, run.t1 = t0, t1

    # answers still due: wait up to DRAIN_S; a closed loop's callers stop
    if mix["loop"] == "closed":
        for r in sender.sent:
            if r.ended is None and r.session is not None:
                r.session.cancel()
                r.cancelled = True
    deadline = time.perf_counter() + DRAIN_S
    while time.perf_counter() < deadline and any(r.ended is None for r in sender.sent):
        time.sleep(0.01)
    run.missed_s = time.perf_counter() - t0
    srv.stop()
    phase("drained and stopped")
    run.requests = sender.sent
    lines.append(f"generator {json.dumps(result)}")
    if on_card:
        torch.cuda.synchronize()
        run.peak = int(torch.cuda.max_memory_allocated())
    if calls is not None:
        run.frame_step_s = calls.frame_step_s()
    del srv, sender, calls, gate
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    for r in run.requests:  # an error may have ended a session before it was kept
        if r.error is None and r.session is not None:
            r.error = r.session.error
    finished = [r for r in run.requests if r.ended is not None and r.error is None
                and not r.cancelled]
    failed = [r for r in run.requests if r.error is not None
              or (r.ended is None and not r.cancelled)]
    attempted = [r for r in run.requests if stats.in_window(r.scheduled, t0, t1)]
    audio_s = stats.samples_in_window(run.requests, t0, t1) / run.sample_rate
    waits = stats.ttfa_s(run.requests, t0, t1, run.missed_s)
    seen = {"attempted": len(attempted), "finished": len(finished), "failed": len(failed),
            "greedy_finished": sum(r.greedy for r in finished), "audio_s_delivered": audio_s,
            "window_s": seconds,
            "first_audio_ms": dict({f"p{q}": 1e3 * stats.percentile(waits, q)
                                    for q in (50, 90, 95, 99)}, mean=1e3 * sum(waits) / len(waits))
            if waits else None}
    lines.append(f"traffic {json.dumps(seen)}")
    rng_check = np.random.default_rng(weights.sub_seeds(seed, 5)[4])
    readings = check.compare(cell.family, cell.config, seed, device, run.voices, finished,
                             rng_check, control=control)
    lines.append(f"reference {json.dumps(readings)}")
    phase("compared with the reference")
    limits, least = s["correct"], int(s["correct"]["min_tokens"])
    ok, check_lines = check.verdict(readings, limits, least)
    return {"run": run, "ok": ok and not failed, "attempted": len(attempted),
            "failed": len(failed), "readings": readings, "lines": lines,
            "check_lines": check_lines, "checks": check.limits_line(readings, limits, least),
            "controls": check.control_verdicts(readings, limits, least) if control else {}}


def metrics_of(run: Run, traced: bool) -> dict:
    """The cell's metrics that its readers found something for."""
    out = {}
    for m in (run.cell.per_layer if traced else run.cell.end_to_end):
        value = specs.reader(run.cell.bench_dir, m.name).read(run, m.name)
        if value is not None:
            out[m.name] = {"value": float(value), "unit": m.unit}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    faulthandler.dump_traceback_later(340)  # where a run that overstays its time is
    cell = specs.load_cell(args.workload)
    name, power = _card(cell.chips)
    import torch

    torch.set_num_threads(4)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    run = out["run"]
    run.device_name = name
    for line in out["lines"]:
        print(line, flush=True)
    metrics = metrics_of(run, bool(args.trace))
    device = {"platform": "gpu", "kind": name, "count": cell.chips,
              "memory_peak_bytes": run.peak, "power_limit_w": power}
    result = {"correct": out["ok"], "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device}
    if args.trace:
        tr = run.trace
        busy = trace.busy_s(tr.records, tr.t0, tr.t1)
        if busy <= 0:
            print("the traced sub-window holds no device work", file=sys.stderr)
            return 1
        device["busy_s"] = busy
        device["window_s"] = tr.window_s
        result["breakdown"] = {
            "device_ops": [list(x) for x in trace.top_ops(tr.records)],
            "idle_gaps": [list(g) for g in trace.idle_gaps(tr.records, tr.t0, tr.t1, tr.host)]}
        seen = {"frame_steps": sum(t.frames for t in tr.ticks()), "ticks": len(tr.ticks()),
                "admissions": len(tr.prefills()), "device_records": len(tr.records),
                "window_s": tr.window_s, "kernels": tr.counts()}
        print(f"trace {json.dumps(seen)}", flush=True)
    result["checks"] = out["checks"]
    loaded = check.forbidden_modules()
    if loaded:
        print(f"the process loaded {loaded}: no result", file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    for line in out["check_lines"]:
        print(line, file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
