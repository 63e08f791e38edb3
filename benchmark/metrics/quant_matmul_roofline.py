"""quant_matmul_roofline: the int8 products' share of their roofline in
the profiled sub-window of the window (harness/trace.py): the least time
the card could take for the bytes and operations that the sub-window's
frame-steps' products need (every trunk weight once a call at S = slots
rows), over the ``quant_matmul`` kernels' summed device time there."""

from benchmark.harness import layers


def read(run, name):
    return layers.quant_roofline(run, r"\bqmm_", 8)
