"""emit_lag_ms: the 95th percentile over the ticks launched in the traced
window before its profiled sub-window of the time from the tick's fetch
event (its frames and PCM copied to the host) to the end of its read and
emission on the host (lag 1), in ms (``harness/spans.py``)."""

from benchmark.harness import spans


def read(run, name):
    lags = [t.read.end - t.stamps["fetch"][0] for t in spans.window_ticks(run)
            if t.read is not None]
    v = spans.p(lags, 95)
    return None if v is None else 1e3 * v
