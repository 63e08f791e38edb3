"""The pool's own spans, as the per-layer readers read them.

The port keeps them (``runtime/serving.py``): each ``Session`` its
``spans`` (name, start, end, cause) and the ``ticks`` it was live at, each
tick its host ``launch`` and ``read`` spans and its device ``stamps`` by
label ("backbone" and "sample" before each frame's replays, "loop",
"mimi", "fetch"), all on ``time.perf_counter``'s clock, the clock of the
run's window.  The harness keeps each request's ``Session``
(``run.requests[i].session``).

The readers read the part of a traced run's window before its profiled
sub-window, ``[run.t0, run.t1 − trace.TRACE_S]``, so CUPTI's cost lies
outside it.  A run without a trace (or on the CPU), and a program whose
sessions keep no spans or device stamps, give nothing to read: None.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from benchmark.harness import stats, trace

LABELS = ("backbone", "sample", "loop", "mimi", "fetch")


def window(run) -> Optional[Tuple[float, float]]:
    """The traced run's window before its profiled sub-window; None
    without a trace."""
    if getattr(run, "trace", None) is None:
        return None
    a, b = run.t0, run.t1 - trace.TRACE_S
    return (a, b) if b > a else None


def sessions(run) -> list:
    return [r.session for r in run.requests if r.session is not None]


def session_spans(run, name: str) -> list:
    """Every session's spans called ``name``."""
    return [sp for s in sessions(run) for sp in getattr(s, "spans", ()) if sp.name == name]


def ticks(run) -> list:
    """The pool's tick records that the run's sessions kept, by id."""
    out = {}
    for s in sessions(run):
        for t in getattr(s, "ticks", ()):
            out[t.id] = t
    return [out[k] for k in sorted(out)]


def stamped(tick) -> bool:
    """Whether ``tick`` has every device stamp, one per frame where due."""
    st = tick.stamps
    return (all(st.get(k) for k in LABELS) and len(st["backbone"]) == len(st["sample"]) == tick.n
            and all(x is not None for k in LABELS for x in st[k]))


def window_ticks(run) -> list:
    """The stamped ticks launched in ``window(run)``."""
    w = window(run)
    if w is None:
        return []
    return [t for t in ticks(run) if t.launch is not None and w[0] <= t.launch.start < w[1]
            and stamped(t)]


def parts(tick) -> Dict[str, List[Tuple[float, float]]]:
    """A stamped tick's device intervals by part: "backbone" (each frame's
    backbone replay), "codebook" (its ``sample`` replay to the next
    frame's backbone or the loop's end: 31 decoder passes, 32 draws and the
    frame's copies), "mimi" (the loop's end → the Mimi stamp) and "copies"
    (→ the fetch event)."""
    st = tick.stamps
    b, s = st["backbone"], st["sample"]
    loop, mimi, fetch = st["loop"][0], st["mimi"][0], st["fetch"][0]
    return {"backbone": list(zip(b, s)), "codebook": list(zip(s, b[1:] + [loop])),
            "mimi": [(loop, mimi)], "copies": [(mimi, fetch)]}


def step_ms(run, part: str) -> Optional[float]:
    """The window's ticks' device ms in ``part`` (``parts``), summed, over
    their frame-steps."""
    ts = window_ticks(run)
    steps = sum(t.n for t in ts)
    if not steps:
        return None
    return 1e3 * sum(b - a for t in ts for a, b in parts(t)[part]) / steps


def device_spans(run) -> List[Tuple[float, float]]:
    """The card's work that the pool gave it: each stamped tick's first
    stamp → its fetch event, and each admission's device span."""
    out = [(t.stamps["backbone"][0], t.stamps["fetch"][0]) for t in ticks(run) if stamped(t)]
    return out + [(sp.start, sp.end) for sp in session_spans(run, "admission")]


def covered_s(intervals, a: float, b: float) -> float:
    """Seconds of [a, b] that the union of ``intervals`` covers."""
    return sum(y - x for x, y in trace.merged([(max(x, a), min(y, b)) for x, y in intervals
                                               if y > a and x < b]))


def idle_pct(run) -> Optional[float]:
    """100 × the share of ``window(run)`` that no device span covers."""
    w = window(run)
    if w is None or not window_ticks(run):
        return None
    return 100.0 * (1.0 - covered_s(device_spans(run), *w) / (w[1] - w[0]))


def p(values, q: float) -> Optional[float]:
    return stats.percentile(values, q)
