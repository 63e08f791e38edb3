"""Open loop: independent users, each request sent at its scheduled time
whatever the system is doing (Poisson arrivals at the mix's rate).

The window of ``seconds`` holds round(rate × seconds) requests.  Their
gaps are the exponential distribution's quantiles at the midpoints of as
many equal slices, in the seed's order, so every seed offers the same
gaps, text rows and budgets in another order.  A request is timed from
its scheduled send; the generator's lateness is recorded beside it.

Mix keys: ``rate_per_s``, ``text_rows`` [lo, hi] a request (the rows a
Llama-3 tokenizer would make of its turn, ``harness/texts.py``),
``sentences`` [lo, hi], ``audio_ms`` [lo, hi] (the request's budget), ``temperature``,
``topk``, ``greedy_every`` (one request in so many is greedy, topk 1),
and optionally ``priority`` (the admission class every request declares;
unset, the server derives it from the budget).
"""

from __future__ import annotations

import time
from typing import List

import numpy as np

from benchmark.harness import texts
from benchmark.harness.client import Request


def plan(mix: dict, rng: np.random.Generator, seconds: float, n_voices: int,
         config: dict) -> List[Request]:
    n = max(1, int(round(mix["rate_per_s"] * seconds)))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / mix["rate_per_s"]
    gaps = rng.permutation(gaps)
    at = np.cumsum(gaps) - gaps[0] * 0.5  # the first arrival half a gap in
    rows = np.round(texts.spread(*mix["text_rows"], n, rng)).astype(int)
    budgets = texts.spread(*mix["audio_ms"], n, rng)
    voices = rng.permutation(np.arange(n) % n_voices)
    greedy = texts.pick(n, mix.get("greedy_every", 0), rng)
    out = []
    for i in range(n):
        k = int(rng.integers(mix["sentences"][0], mix["sentences"][1] + 1))
        out.append(Request(text=texts.sized(config, int(voices[i]), int(rows[i]), k, rng),
                           voice=int(voices[i]),
                           budget_ms=float(budgets[i]),
                           temperature=1.0 if i in greedy else mix["temperature"],
                           topk=1 if i in greedy else mix["topk"],
                           priority=mix.get("priority"), scheduled=float(at[i])))
    return [r for r in out if r.scheduled < seconds]


def drive(send, requests: List[Request], t0: float, t1: float, ended) -> dict:
    """Send each request at ``t0`` + its offset (in perf_counter seconds);
    → the generator's lateness."""
    late = []
    for r in requests:
        r.scheduled = t0 + r.scheduled
        wait = r.scheduled - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        send(r)
        late.append(r.sent - r.scheduled)
    del ended, t1
    return {"sent": len(late), "late_ms_max": 1e3 * max(late, default=0.0),
            "late_ms_p50": 1e3 * float(np.median(late)) if late else 0.0}
