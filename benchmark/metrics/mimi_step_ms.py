"""mimi_step_ms: device ms a frame-step in the tick's batched streaming
Mimi decode: the stamp at the end of a tick's frames → the stamp after the
decode and its cast, summed over the ticks launched in the traced window
before its profiled sub-window, over their frame-steps
(``harness/spans.py``)."""

from benchmark.harness import spans


def read(run, name):
    return spans.step_ms(run, "mimi")
