"""codebook_step_ms: device ms a frame-step from each frame's stamp before
its ``sample`` replay (31 decoder passes, 32 draws, the frame's copies) →
the next frame's backbone stamp, or the loop's end; summed over the ticks
launched in the traced window before its profiled sub-window, over their
frame-steps (``harness/spans.py``)."""

from benchmark.harness import spans


def read(run, name):
    return spans.step_ms(run, "codebook")
