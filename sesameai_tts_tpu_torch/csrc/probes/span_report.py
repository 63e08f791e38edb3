"""One run of a benchmark cell, read through the serving pool's own spans.

    python3 sesameai_tts_tpu_torch/csrc/probes/span_report.py --workload <cell> \\
        --seed <n> [--seconds 51] [--trace 1] [--spans 0] [--bookkeeping 1] [--dump <file>]

From the root of a checkout, on a card.  It runs the cell as
``benchmark/run.py`` does (``run.run_cell``) and prints one JSON line:
``correct``, the cell's end-to-end metrics and, with ``--trace 1``, its
per-layer ones and, over the window the span readers read
(``benchmark/harness/spans.py``):

- ``sum_check``: ``backbone_step_ms + codebook_step_ms`` against
  ``frame_step_ms``;
- ``clock_slack_ms``: the width of the device clock's bracket as each
  tick was mapped (min, p50, p90, max): a mapped stamp lies within half
  of it (a negative width, a bound that did not hold);
- ``lead_ms``: by stamp label, how long after the host issued a stamp the
  card reached it (p1, p10, p50); near 0, the card had run out of work;
- ``stream_idle_pct``: the share of the window that no device span covers
  (the metric's reading: a tick busy from its first stamp to its fetch)
  and ``stream_idle_pct_upper``: the share in which no tick stamp was
  pending, that is issued and not yet reached.  A stamp pending means
  work was queued on the card, so the card starved for at most the upper
  share; ``late_ms`` gives the part of the difference before each label,
  summed over the window (the host late in issuing it);
- ``launch_end_ms``: where each tick's launch returned against the card's
  progress;
- ``gap_parts_ms``: the chunk gaps at or above their p95 split into their
  parts (``gap_parts``);
- ``starved_gaps_ms``: the longest stretches with no device span, named by
  the host spans in flight (``starved_gaps``).

``--spans 0`` builds the pool with its spans switched off.
``--bookkeeping 1`` first times the pool's span bookkeeping for a tick of
10 frame-steps at 16 sessions on the card, without the model: the stamps,
their reading after the fetch's wait, the tick record and a chunk span per
session (the wait itself left out).  ``--dump <file>`` writes each tick of
the window as a JSON line: its frames, live sessions, host launch and read
spans, device stamps and their issue times, in ms from the window's start.
Not part of the package's build or tests.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import functools  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
sys.path.insert(0, ROOT)

from benchmark import run as bench_run  # noqa: E402
from benchmark.harness import spans, specs, trace  # noqa: E402

HOST_SPANS = ("prefill", "handover", "attach")  # a session's spans of host work


def bookkeeping_us(ticks: int = 300, frames: int = 10, live: int = 16) -> dict:
    """Host µs a tick of the pool's span bookkeeping (module docstring)."""
    import torch

    from sesameai_tts_tpu_torch.runtime.serving import BatchedTTSServer as S
    from sesameai_tts_tpu_torch.runtime.serving import Session, Tick
    from sesameai_tts_tpu_torch.utils.profiling import DeviceClock, Metrics

    sessions = [Session(text="x", id=i) for i in range(live)]
    pool = SimpleNamespace(_clock=DeviceClock(True), metrics=Metrics(), spans=True,
                           _sessions=sessions)
    launch, read = [], []
    for i in range(ticks):
        for s in sessions:
            s.ticks.clear()
            s.spans.clear()
        h0 = time.perf_counter()
        tick = Tick(i + 1, frames)
        stamp = S._stamper(pool, tick)
        for _ in range(frames):
            stamp("backbone")
            stamp("sample")
        stamp("loop")
        stamp("mimi")
        S._launched(pool, tick, h0)
        fetch = SimpleNamespace(event=pool._clock.event(), issued=time.perf_counter(),
                                waited=None)
        fetch.event.record()
        h1 = time.perf_counter()
        fetch.event.synchronize()
        fetch.waited = h2 = time.perf_counter()
        S._read_stamps(pool, tick, fetch)
        for s in sessions:
            S._span(pool, s, "chunk", h2, h2, tick.id)
        launch.append(h1 - h0)
        read.append(time.perf_counter() - h2)
    torch.cuda.synchronize()
    keep = slice(ticks // 10, None)  # the first ticks make the pool's events
    lo, rd = sorted(launch[keep]), sorted(read[keep])
    return {"ticks": len(lo), "frames": frames, "live": live,
            "launch_us_p50": 1e6 * lo[len(lo) // 2], "read_us_p50": 1e6 * rd[len(rd) // 2],
            "total_us_mean": 1e6 * (sum(lo) + sum(rd)) / len(lo)}


def host_spans(run) -> list:
    """The pool's host work: the ticks' launches and reads, the sessions'
    prefills, hand-overs and attaches."""
    out = []
    for t in spans.ticks(run):
        out += [trace.HostCall(sp.name, sp.start, sp.end, t.n, ())
                for sp in (t.launch, t.read) if sp is not None]
    for s in spans.sessions(run):
        out += [trace.HostCall(sp.name, sp.start, sp.end, 0, ())
                for sp in getattr(s, "spans", ()) if sp.name in HOST_SPANS]
    return out


def starved_gaps(run, top: int = 10):
    """The longest stretches of the window with no device span, each named
    by the host spans in flight during it → [(name, seconds)]."""
    w = spans.window(run)
    if w is None or not spans.window_ticks(run):
        return None
    busy = [trace.Kernel("device", a, b) for a, b in spans.device_spans(run)]
    return trace.idle_gaps(busy, w[0], w[1], host_spans(run), top)


def _overlap(a: float, b: float, x: float, y: float) -> float:
    return max(0.0, min(b, y) - max(a, x))


def gap_parts(run, q: float = 95.0):
    """The chunk gaps at or above their ``q``-th percentile (a gap: two
    chunks of one session, the later emitted in the window), split into
    the mean seconds of each part: "slot_wait", "attach", "ahead" (the
    attach, or the earlier chunk, → the making tick's first stamp), the
    making tick's "backbone", "codebook", "mimi" and "copies", and "emit"
    (its fetch → the later chunk).  The parts are contiguous by
    construction, so they sum to the gap."""
    w = spans.window(run)
    if w is None:
        return None
    by_id = {t.id: t for t in spans.ticks(run) if spans.stamped(t)}
    gaps = []
    for s in spans.sessions(run):
        sps = getattr(s, "spans", ())
        chunks = [sp for sp in sps if sp.name == "chunk"]
        named = {sp.name: sp for sp in sps if sp.name in ("slot_wait", "attach")}
        for c1, c2 in zip(chunks, chunks[1:]):
            if w[0] <= c2.end < w[1] and c2.cause in by_id:
                gaps.append((c1, c2, named))
    if not gaps:
        return None
    cut = spans.p([c2.end - c1.end for c1, c2, _ in gaps], q)
    top = [g for g in gaps if g[1].end - g[0].end >= cut]
    keys = ("slot_wait", "attach", "ahead", "backbone", "codebook", "mimi", "copies", "emit")
    sums = dict.fromkeys(keys, 0.0)
    for c1, c2, named in top:
        e1, e2 = c1.end, c2.end
        got = {k: _overlap(e1, e2, sp.start, sp.end) for k, sp in named.items()}
        st = by_id[c2.cause].stamps
        start = max([e1] + [sp.end for k, sp in named.items() if k == "attach" and sp.end <= e2])
        got["ahead"] = _overlap(e1, e2, start, st["backbone"][0])
        for part, sp_ in spans.parts(by_id[c2.cause]).items():
            got[part] = sum(_overlap(e1, e2, a, b) for a, b in sp_)
        got["emit"] = _overlap(e1, e2, st["fetch"][0], e2)
        for k in keys:
            sums[k] += got.get(k, 0.0)
    out = {"p": cut, "gaps": len(top), "first": sum(1 for c1, _, _ in top if c1.cause == 0)}
    out.update({k: v / len(top) for k, v in sums.items()})
    return out


def _ordered(tick) -> list:
    """A stamped tick's stamps in stream order → [(label, device s, issued s)]."""
    st, iss = tick.stamps, tick.issued
    out = []
    for i in range(tick.n):
        out += [("backbone", st["backbone"][i], iss["backbone"][i]),
                ("sample", st["sample"][i], iss["sample"][i])]
    return out + [(k, st[k][0], iss[k][0]) for k in ("loop", "mimi", "fetch")]


def idle_bracket(run):
    """The window's idle share between two readings (module docstring):
    → {"stream_idle_pct", "stream_idle_pct_upper", "late_ms": {label: ms},
    "lead_ms": {label: [p1, p10, p50]}, "clock_slack_ms": [min, p50, p90, max]}."""
    w = spans.window(run)
    ts = [t for t in spans.window_ticks(run) if getattr(t, "issued", None)]
    if w is None or not ts:
        return None
    pending, late, leads = [], {}, {}
    for t in ts:
        prev = None
        for label, dev, issued in _ordered(t):
            pending.append((issued, dev))
            leads.setdefault(label, []).append(dev - issued)
            if prev is not None:  # the card may have starved in [prev, issued]
                a, b = max(prev, w[0]), min(issued, dev, w[1])
                late[label] = late.get(label, 0.0) + max(0.0, b - a)
            prev = dev
    span = w[1] - w[0]
    slack = [t.slack for t in ts if t.slack is not None]
    return {"stream_idle_pct": spans.idle_pct(run),
            "stream_idle_pct_upper": 100.0 * (1.0 - spans.covered_s(pending, *w) / span),
            "late_ms": {k: 1e3 * v for k, v in late.items()},
            "lead_ms": {k: [1e3 * spans.p(v, q) for q in (1, 10, 50)] for k, v in leads.items()},
            "clock_slack_ms": [1e3 * spans.p(slack, q) for q in (0, 50, 90, 100)] if slack else None}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=51.0)
    p.add_argument("--trace", type=int, choices=(0, 1), default=1)
    p.add_argument("--spans", type=int, choices=(0, 1), default=1)
    p.add_argument("--bookkeeping", type=int, choices=(0, 1), default=0)
    p.add_argument("--dump", default=None)
    args = p.parse_args(argv)
    cell = specs.load_cell(args.workload)
    name, power = bench_run._card(cell.chips)
    import torch

    torch.set_num_threads(4)
    extra = {}
    if args.bookkeeping:
        extra["bookkeeping"] = bookkeeping_us()
    if not args.spans:
        from sesameai_tts_tpu_torch.runtime import serving

        serving.BatchedTTSServer = functools.partial(serving.BatchedTTSServer, spans=False)
    out = bench_run.run_cell(cell, args.seed, args.seconds, bool(args.trace), t_start=T_START)
    run = out["run"]
    run.device_name = name
    for line in out["lines"]:
        print(line, flush=True)
    result = {"workload": args.workload, "seed": args.seed, "spans": args.spans,
              "trace": args.trace, "correct": out["ok"], "failed": out["failed"],
              "device": name, "power_limit_w": power,
              "metrics": {k: v["value"] for k, v in bench_run.metrics_of(run, False).items()}}
    if args.trace:
        result["per_layer"] = pl = {k: v["value"] for k, v in bench_run.metrics_of(run, True).items()}
        if "backbone_step_ms" in pl and "frame_step_ms" in pl:
            both = pl["backbone_step_ms"] + pl["codebook_step_ms"]
            result["sum_check"] = {"backbone+codebook": both, "frame_step_ms": pl["frame_step_ms"],
                                   "ratio": both / pl["frame_step_ms"]}
        result.update(idle_bracket(run) or {})
        result["gap_parts_ms"] = {k: (1e3 * v if k not in ("gaps", "first") else v)
                                  for k, v in (gap_parts(run) or {}).items()}
        result["starved_gaps_ms"] = [[n, 1e3 * s] for n, s in (starved_gaps(run) or [])]
        w = spans.window(run)
        ts = spans.window_ticks(run)
        by_id = {t.id: t for t in ts}
        ends = {"own_first_stamp": [t.launch.end - t.stamps["backbone"][0] for t in ts],
                "own_loop_end": [t.launch.end - t.stamps["loop"][0] for t in ts],
                "tick_ahead_fetch": [t.launch.end - by_id[t.id - 1].stamps["fetch"][0]
                                     for t in ts if t.id - 1 in by_id]}
        # where each launch returned, against the card's progress (ms: p10, p50, p90)
        result["launch_end_ms"] = {k: [1e3 * spans.p(v, q) for q in (10, 50, 90)]
                                   for k, v in ends.items() if v}
        result["window_ticks"] = len(ts)
        result["window_s"] = None if w is None else w[1] - w[0]
        if args.dump:
            ms = lambda t: round(1e3 * (t - run.t0), 3)  # noqa: E731
            with open(args.dump, "w") as f:
                for t in ts:
                    f.write(json.dumps({"id": t.id, "n": t.n, "live": len(t.live),
                                        "launch": [ms(t.launch.start), ms(t.launch.end)],
                                        "read": [ms(t.read.start), ms(t.read.end)],
                                        "stamps": {k: [ms(x) for x in v]
                                                   for k, v in t.stamps.items()},
                                        "issued": {k: [ms(x) for x in v]
                                                   for k, v in t.issued.items()},
                                        "slack_ms": None if t.slack is None
                                        else round(1e3 * t.slack, 4)}) + "\n")
    result.update(extra)
    print(json.dumps(result), flush=True)
    for line in out["check_lines"]:
        print(line, file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
