"""backbone_step_ms: device ms a frame-step in the backbone graph, from the
pool's own stamps (``harness/spans.py``): each frame's stamp before its
``backbone`` replay → the stamp before its ``sample`` replay, summed over
the ticks launched in the traced window before its profiled sub-window,
over their frame-steps."""

from benchmark.harness import spans


def read(run, name):
    return spans.step_ms(run, "backbone")
