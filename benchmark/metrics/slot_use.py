"""slot_use: frames delivered in the window over the frame-steps the pool
ran in it times its slots, in percent (the pool's ``tick_frames``
counter and the chunks received)."""

from benchmark.harness import stats


def read(run, name):
    steps = run.counters.get("frame_steps", 0)
    if not steps:
        return None
    frames = stats.samples_in_window(run.requests, run.t0, run.t1) / run.hop
    return 100.0 * frames / (steps * run.slots)
