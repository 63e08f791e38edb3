"""step_mfu(.<cell kind>): the model operations of the window's work
(each admission's prefill and each frame delivered in the window, from
the published shapes) over the window's seconds at the card's dense
bf16 peak, in percent."""

from benchmark.harness import layers


def read(run, name):
    return layers.mfu(run)
