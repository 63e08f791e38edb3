"""flash_attention_roofline(.<cell kind>): the attention's share of its
roofline in the profiled sub-window of the window: the least time for
the bytes and operations that the sub-window's ticks (each live
session's backbone step over the rows its cache holds, its decoder
passes over 1..K rows) and admissions' prefills need, over the
``flash_attention`` kernels' summed device time there."""

from benchmark.harness import layers


def read(run, name):
    return layers.attention_roofline(run, r"\bflash_fwd")
