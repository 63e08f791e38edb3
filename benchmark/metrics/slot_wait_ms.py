"""slot_wait_ms: the 95th percentile over the admissions attached in the
traced window before its profiled sub-window of their ``slot_wait`` span
(the prefilled session queued for a slot → its attach begins), in ms
(``harness/spans.py``)."""

from benchmark.harness import spans


def read(run, name):
    w = spans.window(run)
    if w is None or not spans.window_ticks(run):
        return None
    waits = [sp.end - sp.start for sp in spans.session_spans(run, "slot_wait")
             if w[0] <= sp.end < w[1]]
    v = spans.p(waits, 95)
    return None if v is None else 1e3 * v
