"""quant4_matmul_roofline: as ``quant_matmul_roofline``, for the int4
products and the ``quant4_matmul`` kernels."""

from benchmark.harness import layers


def read(run, name):
    return layers.quant_roofline(run, r"\bq4mm_", 4)
