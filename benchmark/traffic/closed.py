"""Closed loop: ``clients`` callers, each sending its next request when
its last one ends, until the window closes.

Each client has a queue of requests drawn from the seed; the pool of all
clients' requests holds the same text rows and budgets on every seed,
in another order.  A request is timed from when it was sent.

Mix keys: ``clients``, ``per_client`` (requests queued a client),
``text_rows`` [lo, hi] a request (the rows a Llama-3 tokenizer would make
of its turn, ``harness/texts.py``), ``sentences`` [lo, hi], ``audio_ms``
[lo, hi], ``temperature``, ``topk``, ``greedy_every``.
"""

from __future__ import annotations

import queue
import time
from typing import List

import numpy as np

from benchmark.harness import texts
from benchmark.harness.client import Request


def plan(mix: dict, rng: np.random.Generator, seconds: float, n_voices: int,
         config: dict) -> List[Request]:
    del seconds
    c, m = mix["clients"], mix["per_client"]
    n = c * m
    n_sent = np.round(texts.spread(mix["sentences"][0] - 0.5, mix["sentences"][1] + 0.5, n,
                                   rng)).astype(int)
    rows = np.round(texts.spread(*mix["text_rows"], n, rng)).astype(int)
    budgets = texts.spread(*mix["audio_ms"], n, rng)
    greedy = texts.pick(n, mix.get("greedy_every", 0), rng)
    out = []
    for i in range(n):
        out.append(Request(text=texts.sized(config, i % n_voices, int(rows[i]), int(n_sent[i]),
                                            rng),
                           voice=i % n_voices, budget_ms=float(budgets[i]),
                           temperature=1.0 if i in greedy else mix["temperature"],
                           topk=1 if i in greedy else mix["topk"], client=i % c))
    return out


def drive(send, requests: List[Request], t0: float, t1: float, ended: "queue.Queue") -> dict:
    """Each client sends its first request at ``t0``, then its next one as
    soon as ``ended`` reports its last one done, while the window is open."""
    queues = {}
    for r in requests:
        queues.setdefault(r.client, []).append(r)
    for c in sorted(queues):
        r = queues[c].pop(0)
        r.scheduled = time.perf_counter()
        send(r)
    while True:
        left = t1 - time.perf_counter()
        if left <= 0:
            break
        try:
            done = ended.get(timeout=min(left, 0.05))
        except queue.Empty:
            continue
        if queues.get(done.client) and time.perf_counter() < t1:
            r = queues[done.client].pop(0)
            r.scheduled = time.perf_counter()
            send(r)
    return {"clients": len(queues), "unsent": sum(len(q) for q in queues.values())}
