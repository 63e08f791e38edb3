"""stream_idle_pct(.<cell kind>): the share, in percent, of the traced
window before its profiled sub-window that neither a tick's device span
(its first stamp → its fetch event) nor an admission's covers
(``harness/spans.py``): the gaps between the pool's ticks and admissions.
A tick counts busy throughout, so bubbles inside a graph replay and
stretches in which the card waited for the host inside a tick (its eager
Mimi decode) count as busy: the share reads low where the host is late."""

from benchmark.harness import spans


def read(run, name):
    return spans.idle_pct(run)
