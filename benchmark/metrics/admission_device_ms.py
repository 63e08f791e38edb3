"""admission_device_ms: the median over the admissions begun in the traced
window before its profiled sub-window of their device span: a stamp on
the admission stream before the prefill → the fetch event after its first
chunk, in ms (``harness/spans.py``)."""

from benchmark.harness import spans


def read(run, name):
    w = spans.window(run)
    if w is None:
        return None
    spans_ = [sp.end - sp.start for sp in spans.session_spans(run, "admission")
              if w[0] <= sp.start < w[1]]
    v = spans.p(spans_, 50)
    return None if v is None else 1e3 * v
