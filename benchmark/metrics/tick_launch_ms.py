"""tick_launch_ms: the 95th percentile over the ticks launched in the
traced window before its profiled sub-window of the host's launch span
(the pool's ``_serve_tick`` call) over the tick's frame-steps, in ms
(``harness/spans.py``)."""

from benchmark.harness import spans


def read(run, name):
    per_step = [(t.launch.end - t.launch.start) / t.n for t in spans.window_ticks(run)]
    v = spans.p(per_step, 95)
    return None if v is None else 1e3 * v
