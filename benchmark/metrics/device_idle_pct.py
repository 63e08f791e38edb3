"""device_idle_pct(.<cell kind>): the share of the traced run's window,
up to its profiled sub-window, in which no kernel ran on the card, by
the card's own utilization counter (``nvidia-smi``'s ``utilization.gpu``,
sampled every 200 ms; ``harness/trace.py``), in percent."""

from benchmark.harness import layers


def read(run, name):
    return layers.idle_pct(run)
