"""audio_s_per_s: seconds of 24 kHz audio that reached clients in the
window, over the window's seconds."""

from benchmark.harness import stats


def read(run, name):
    return stats.samples_in_window(run.requests, run.t0, run.t1) / run.sample_rate / run.seconds
