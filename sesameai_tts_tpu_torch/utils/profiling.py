"""Profiling and structured metrics: bounded per-stage metric series with
a wall-clock timer and a JSON dump (``Metrics``, the port of
``sesameai_tts_tpu/utils/profiling.py``'s), spans on the host's clock
(``Span``), and device stamps placed on that clock without a host
synchronisation of their own (``DeviceClock``).

Every time here is ``time.perf_counter()`` seconds.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from collections import defaultdict
from typing import Callable, Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np


class Span(NamedTuple):
    """A named interval on ``time.perf_counter``'s clock, and the id of the
    request or tick that caused it."""

    name: str
    start: float
    end: float
    cause: int

    @property
    def seconds(self) -> float:
        return self.end - self.start


class Metrics:
    """Thread-safe metric series, each bounded to the latest ``maxlen``
    samples; values are seconds or caller-defined units."""

    def __init__(self, maxlen: int = 4096):
        self._lock = threading.Lock()
        self._maxlen = maxlen
        self._series: Dict[str, List[float]] = defaultdict(list)

    def record(self, name: str, value: float) -> None:
        with self._lock:
            s = self._series[name]
            s.append(float(value))
            if len(s) > self._maxlen:
                del s[: len(s) - self._maxlen]

    def record_span(self, name: str, span: Span) -> Span:
        """Record ``span``'s seconds under the series ``name`` → the span."""
        self.record(name, span.seconds)
        return span

    @contextlib.contextmanager
    def timer(self, name: str) -> Iterator[None]:
        """Record the block's wall-clock seconds under ``name``."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, time.perf_counter() - t0)

    def summary(self) -> Dict[str, dict]:
        with self._lock:
            out = {}
            for name, vals in self._series.items():
                arr = np.asarray(vals)
                out[name] = {
                    "count": int(arr.size),
                    "total": float(arr.sum()),
                    "mean": float(arr.mean()),
                    "p50": float(np.percentile(arr, 50)),
                    "p90": float(np.percentile(arr, 90)),
                    "max": float(arr.max()),
                }
            return out

    def dump_json(self) -> str:
        return json.dumps(self.summary(), indent=2)

    def reset(self) -> None:
        with self._lock:
            self._series.clear()


def _timing_event():
    import torch

    return torch.cuda.Event(enable_timing=True)


class Stamp(NamedTuple):
    """A timing event and the host time just before it was recorded: the
    device reaches the event no earlier than ``issued``."""

    event: object
    issued: float


class _Bounds:
    """One side of the bracket on the offset o = host time − device time.
    A bound is (host s, event).  ``upper``: a wait that returned at h shows
    the event done by h, so o ≤ h − t(event); else an event recorded after
    host time r is reached no earlier, so o ≥ r − t(event).  The clocks'
    rates differ by at most ``drift``, so a bound taken at host time h
    loosens by ``drift`` × |now − h| since: the side keeps the one bound
    that is tightest from now on."""

    def __init__(self, upper: bool, drift: float):
        self.upper = upper
        self.drift = drift
        self.best: Optional[Tuple[float, object]] = None

    def _tighter(self, a: Tuple[float, object], b: Tuple[float, object]) -> bool:
        # a later bound a against b, both aged to a time after them:
        # (h_a − t_a) ± drift·(now − h_a) against the same of b, with
        # t_a − t_b = elapsed(b → a)
        rate = 1.0 - self.drift if self.upper else 1.0 + self.drift
        d = (a[0] - b[0]) * rate - b[1].elapsed_time(a[1]) * 1e-3
        return d < 0 if self.upper else d > 0

    def add(self, host_s: float, event) -> None:
        new = (host_s, event)
        if self.best is None or self._tighter(new, self.best):
            self.best = new

    def at(self, event, now_s: float) -> float:
        """``event``'s host time by this side's bound, aged to ``now_s``."""
        h, ref = self.best
        age = self.drift * abs(now_s - h)
        return h + ref.elapsed_time(event) * 1e-3 + (age if self.upper else -age)


class DeviceClock:
    """Device stamps on ``time.perf_counter``'s clock.

    ``stamp()`` records a timing event on the current stream (None on the
    CPU) from a pool of reusable events, with the host time just before
    (``Stamp``).  A stamp is read only after a wait that its caller makes
    anyway has covered it (``settle``), so the clock adds no host
    synchronisation.

    The waits and the stamps bracket the offset between the clocks: a
    wait on an event that returns at host time h shows that the event
    completed no later, so (host time − device time) ≤ h − t(event); an
    event recorded at host time r completes no earlier, so the offset is
    ≥ r − t(event).  The two clocks' rates differ by at most ``drift`` (a
    fraction), so a bound loosens by that much of its age; each side keeps
    its tightest bound so aged, and a device time maps onto the host's
    clock through the middle of the bracket, within ± half its width
    (``slack``).  A bound taken when the card was idle (a stamp reached as
    it was issued, a wait begun before its event) thus holds for as long
    as it stays the tightest, and the drift widens the bracket rather than
    moving a reading.  Device times are differences of events
    (``elapsed_time``, ms), so the events of the bounds are kept.

    ``make_event`` makes an unrecorded event with ``record()`` and
    ``elapsed_time(other)`` (ms from it to ``other``); ``on_device`` False
    makes every stamp None."""

    POOL = 256  # free events kept for reuse

    def __init__(self, on_device: bool, drift: float = 1e-4,
                 make_event: Callable[[], object] = _timing_event):
        self.on_device = on_device
        self._make = make_event
        self._free: List[object] = []
        self._upper = _Bounds(True, drift)
        self._lower = _Bounds(False, drift)
        self._now: Optional[float] = None  # the last wait's host time
        self._lock = threading.Lock()

    def event(self):
        """An unrecorded timing event (None on the CPU): a fetch's own."""
        return self._make() if self.on_device else None

    def stamp(self) -> Optional[Stamp]:
        """A timing event recorded now on the current stream; None on the CPU."""
        if not self.on_device:
            return None
        with self._lock:
            ev = self._free.pop() if self._free else None
        if ev is None:
            ev = self._make()
        issued = time.perf_counter()
        ev.record()
        return Stamp(ev, issued)

    def release(self, events) -> None:
        """Stamps' events that have been read, back into the pool."""
        with self._lock:
            for ev in events:
                if ev is not None and len(self._free) < self.POOL:
                    self._free.append(ev)

    def settle(self, stamps: Sequence[Stamp], waited: Stamp,
               waited_s: float) -> List[float]:
        """A wait on ``waited`` returned at ``waited_s``, and it covered
        ``stamps`` (recorded before it on its stream): both bounds from
        them, then the stamps' and ``waited``'s device times on the host's
        clock, in that order.  The stamps' events go back into the pool but
        the one kept as a bound."""
        ref = waited.event
        with self._lock:
            self._upper.add(waited_s, ref)
            rel = [ref.elapsed_time(s.event) * 1e-3 for s in stamps]  # t(s) − t(waited)
            # of the stamps and the waited event, the tightest lower bound
            vals = [s.issued - d for s, d in zip(stamps, rel)] + [waited.issued]
            k = max(range(len(vals)), key=vals.__getitem__)
            kept = waited if k == len(stamps) else stamps[k]
            self._lower.add(kept.issued, kept.event)
            self._now = waited_s
            at = 0.5 * (self._upper.at(ref, waited_s) + self._lower.at(ref, waited_s))
        self.release(s.event for i, s in enumerate(stamps) if i != k)
        return [at + d for d in rel] + [at]

    def slack(self) -> Optional[float]:
        """The bracket's width at the last ``settle``, seconds (upper −
        lower bound on the offset): a time it mapped lies within half of
        it; None before the first.  Negative would mean a bound that does
        not hold (the clocks drifted apart faster than ``drift``)."""
        with self._lock:
            if self._now is None:
                return None
            ref = self._upper.best[1]
            return self._upper.at(ref, self._now) - self._lower.at(ref, self._now)
