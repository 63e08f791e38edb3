"""The end-to-end arithmetic: percentiles, and what the client saw in the
window (first audio timed from the scheduled send, the gaps between
chunks, the audio delivered)."""

from __future__ import annotations

import math
from typing import Iterable, List, Optional, Sequence


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The q-th percentile by linear interpolation between closest ranks
    (numpy's default); None for no values."""
    xs = sorted(values)
    if not xs:
        return None
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def in_window(t: float, t0: float, t1: float) -> bool:
    return t0 <= t < t1


def ttfa_s(requests: Iterable, t0: float, t1: float, missed_s: float) -> List[float]:
    """Seconds from each request's scheduled send to its first chunk, for
    the requests scheduled in [t0, t1); a request that failed or never
    answered counts ``missed_s`` (longer than any answer waited for)."""
    out = []
    for r in requests:
        if not in_window(r.scheduled, t0, t1):
            continue
        first = r.first_chunk_at()
        out.append(missed_s if first is None or r.error is not None else first - r.scheduled)
    return out


def chunk_gaps_s(requests: Iterable, t0: float, t1: float) -> List[float]:
    """Every gap between consecutive chunks of one request whose later
    chunk reached the client in [t0, t1)."""
    out = []
    for r in requests:
        times = [t for t, _ in r.chunk_log]
        for a, b in zip(times, times[1:]):
            if in_window(b, t0, t1):
                out.append(b - a)
    return out


def samples_in_window(requests: Iterable, t0: float, t1: float) -> int:
    """PCM samples that reached clients in [t0, t1)."""
    return sum(n for r in requests for t, n in r.chunk_log if in_window(t, t0, t1))
