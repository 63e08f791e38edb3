"""What the traced run measures on the card, from the benchmark's own
files.

``Calls``: the pool's calls into its layers over the window, wrapped on
the instances (the classes keep their methods): a tick's launch
(``_serve_tick``), the read of the tick before it (``_process``), an
attach (``_attach``), an admission's prefill (``_prefill_admission``),
first chunk (``_first_chunk``) and hand-over (``_complete_admission``).
Each call's host interval is kept, with the frame-steps of a tick and
the sessions live at its launch; the tick clone's frame-steps
(``_replay_frames``) are also timed by CUDA events on its stream.

``Gate``: holds the tick thread before its next tick and the dispatch
thread before its next admission, and waits until neither is inside one;
with the card then synchronized nothing of the pool runs.

``sub_window``: ``torch.profiler`` (CUPTI) over the window's last
``TRACE_S`` seconds, of the pool's own graph replays and admissions.  It
is started and stopped only while the gate holds the pool: stopping it
while other threads launch graphs hung the process.  CUPTI records the
kernels of a graph only if it was running when the graph was captured, so
a traced run starts it once (``init_cupti``) before the program captures
anything.  A marker kernel launched while the pool is held ties the
host's clock to the trace's.  While CUPTI records a graph's kernels its
launches take longer on the host, so the sub-window's idle share is the
profiler's as much as the pool's: the kernels' times are read from it,
the idle share from ``Utilization``.

``Utilization``: the card's own utilization counter (``nvidia-smi``'s
``utilization.gpu``: the share of each sample period in which a kernel
ran) over the window before the sub-window, sampled every 200 ms.
"""

from __future__ import annotations

import atexit
import re
import subprocess
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Tuple

TRACE_S = 1.5  # the profiled sub-window: ~30 frame-steps, ~400,000 kernels at B = 16


class Kernel(NamedTuple):
    """One record of the card's work in a trace: a kernel, copy or set."""

    name: str
    start: float  # seconds on the trace's clock
    end: float


def kernels(results) -> List[Kernel]:
    """The device records of a profiler's results."""
    out = []
    for e in results.events():
        if "CUDA" in str(e.device_type()):
            start = e.start_ns() * 1e-9
            out.append(Kernel(e.name(), start, start + e.duration_ns() * 1e-9))
    return out


def init_cupti() -> None:
    """Start and stop CUPTI once, before any graph is captured."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]):
        torch.zeros(8, device="cuda").add_(1)
        torch.cuda.synchronize()


def top_ops(records: List[Kernel], top: int = 10) -> List[Tuple[str, float]]:
    """The device operations that took the most time."""
    by_name = defaultdict(float)
    for e in records:
        by_name[e.name[:120]] += e.end - e.start
    return sorted(by_name.items(), key=lambda kv: -kv[1])[:top]


def merged(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """``spans`` as disjoint intervals, in order."""
    out: List[List[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        elif b > a:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_s(records: List[Kernel], t0: float, t1: float) -> float:
    """Seconds of [t0, t1] in which some operation ran on the card."""
    return sum(b - a for a, b in merged([(max(k.start, t0), min(k.end, t1)) for k in records
                                          if k.end > t0 and k.start < t1]))


def idle_gaps(records: List[Kernel], t0: float, t1: float, host: List["HostCall"],
              top: int = 10) -> List[Tuple[str, float]]:
    """The longest stretches of [t0, t1] with nothing running on the card,
    each named by the pool's host calls in flight during it (on the
    trace's clock), longest overlap first, or "none" → longest first."""
    busy = merged([(max(k.start, t0), min(k.end, t1)) for k in records
                   if k.end > t0 and k.start < t1])
    edges = [t0] + [x for ab in busy for x in ab] + [t1]
    gaps = []
    for a, b in zip(edges[::2], edges[1::2]):
        if b - a <= 0:
            continue
        overlap = defaultdict(float)
        for h in host:
            o = min(b, h.end) - max(a, h.start)
            if o > 0:
                overlap[h.kind] += o
        name = "+".join(k for k, _ in sorted(overlap.items(), key=lambda kv: -kv[1])) or "none"
        gaps.append((name, b - a))
    return sorted(gaps, key=lambda g: -g[1])[:top]


class HostCall(NamedTuple):
    kind: str  # "tick", "read", "attach", "prefill", "first_chunk", "handover"
    start: float  # perf_counter seconds (or the trace's clock, once shifted)
    end: float
    frames: int  # a tick's frame-steps
    live: tuple  # a tick's live sessions at launch: (session id, frames emitted)
    text: object = None  # an admission's text and speaker


_WRAPPED = (("_ticker", "_serve_tick", "tick"), ("", "_process", "read"),
            ("", "_attach", "attach"), ("_admitter", "_prefill_admission", "prefill"),
            ("_admitter", "_first_chunk", "first_chunk"), ("", "_complete_admission", "handover"))


class Calls:
    """The pool's calls into its layers over the window (module docstring)."""

    def __init__(self, server):
        self.server = server
        self.host: List[HostCall] = []
        self._frames: List[tuple] = []  # (event before, event after, frame-steps)
        self._in_window: Optional[int] = None
        self._lock = threading.Lock()

    def _wrap(self, obj, name: str, kind: str) -> None:
        fn = getattr(obj, name)
        server = self.server

        def wrapped(*a, **k):
            live, frames, text = (), 0, None
            if kind == "tick":
                frames = int(a[1])
                live = tuple((id(s), sum(f.shape[0] for f in s.frames_out))
                             for s in server._sessions if s is not None)
            elif kind == "prefill":
                text = (a[0], a[1])
            h0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                with self._lock:
                    self.host.append(HostCall(kind, h0, time.perf_counter(), frames, live, text))

        setattr(obj, name, wrapped)

    def install(self) -> None:
        import torch

        srv = self.server
        for owner, name, kind in _WRAPPED:
            self._wrap(getattr(srv, owner) if owner else srv, name, kind)
        replay = srv._ticker._replay_frames

        def timed(*a, **k):
            e0 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = replay(*a, **k)
            e1 = torch.cuda.Event(enable_timing=True)
            e1.record()
            self._frames.append((e0, e1, int(a[2])))
            return out

        srv._ticker._replay_frames = timed

    def close(self) -> None:
        """The window has closed: later frame-steps are not its own."""
        self._in_window = len(self._frames)

    def frame_step_s(self) -> Optional[float]:
        """Device seconds a frame-step: the window's ``_replay_frames``
        calls' CUDA events, summed, over their frame-steps (once the card
        is idle)."""
        frames = self._frames[:self._in_window]
        steps = sum(n for _, _, n in frames)
        if not steps:
            return None
        return sum(e0.elapsed_time(e1) for e0, e1, _ in frames) * 1e-3 / steps


class Gate:
    """Holds the pool's tick and dispatch threads (module docstring)."""

    def __init__(self, server):
        self._open = threading.Event()
        self._open.set()
        self._inside = 0
        self._lock = threading.Lock()
        for name in ("_tick", "_dispatch_admission"):
            self._wrap(server, name)

    def _wrap(self, obj, name: str) -> None:
        fn = getattr(obj, name)

        def gated(*a, **k):
            while True:  # counted inside before the look, so ``hold`` sees it
                with self._lock:
                    self._inside += 1
                if self._open.is_set():
                    break
                with self._lock:
                    self._inside -= 1
                self._open.wait()
            try:
                return fn(*a, **k)
            finally:
                with self._lock:
                    self._inside -= 1

        setattr(obj, name, gated)

    def hold(self, timeout: float = 30.0) -> None:
        """Let no new tick or admission start, wait for those in flight,
        and for the card to finish what they launched."""
        import torch

        self._open.clear()
        deadline = time.perf_counter() + timeout
        while True:
            with self._lock:
                if self._inside == 0:
                    break
            if time.perf_counter() > deadline:
                raise RuntimeError("the pool did not come to rest")
            time.sleep(0.0005)
        torch.cuda.synchronize()

    def release(self) -> None:
        self._open.set()


@dataclass
class Trace:
    """A profiled sub-window, its clock tied to the host's."""

    records: List[Kernel]
    t0: float  # the sub-window on the trace's clock: the pool released ...
    t1: float  # ... to the end of the last operation it ran
    offset: float  # trace clock − perf_counter
    host: List[HostCall] = field(default_factory=list)  # calls begun in it, on the trace's clock

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def kernel_s(self, pattern: str) -> float:
        rx = re.compile(pattern)
        return sum(k.end - k.start for k in self.records
                   if rx.search(k.name) and k.start >= self.t0)

    def ticks(self) -> List[HostCall]:
        return [h for h in self.host if h.kind == "tick"]

    def prefills(self) -> List[HostCall]:
        return [h for h in self.host if h.kind == "prefill"]

    def counts(self) -> Dict[str, int]:
        """Records a kernel name of the quantized products and attention."""
        out: Dict[str, int] = defaultdict(int)
        for k in self.records:
            m = re.search(r"\b(qmm_\w+|q4mm_\w+|flash_\w+)", k.name)
            if m:
                out[m.group(1)] += 1
        return dict(out)


def _profiler():
    """A CUDA-only profiler, started and stopped by hand (its results are
    read raw, not parsed op by op)."""
    from torch.autograd import profiler as ap

    return ap.profile(use_cpu=False, use_device="cuda", use_kineto=True)


def sub_window(gate: Gate, calls: Calls, seconds: float = TRACE_S) -> Trace:
    """Profile the pool for ``seconds``: hold it, start CUPTI, mark the
    clock, release it, wait, hold it again, stop CUPTI.  The pool is left
    held: the caller releases it."""
    import torch
    from torch.autograd import _disable_profiler
    from torch.autograd import profiler as ap

    prof = _profiler()
    gate.hold()
    prof.__enter__()
    try:
        torch.cuda.synchronize()
        h_mark = time.perf_counter()
        torch.cuda._sleep(1000)  # a marker kernel, nothing else running
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        gate.release()
        time.sleep(seconds)
        gate.hold()
        h1 = time.perf_counter()
    finally:
        results = _disable_profiler()
        stop = getattr(ap, "_run_on_profiler_stop", None)
        if stop is not None:
            stop()
    records = sorted(kernels(results), key=lambda k: k.start)
    # the pool was held: the marker is the only record before the release
    marker = next((k for k in records if "spin_kernel" in k.name), records[0])
    offset = marker.start - h_mark
    t0 = h0 + offset
    records = [k for k in records if k.start >= t0]
    t1 = max((k.end for k in records), default=t0)
    host = [HostCall(h.kind, h.start + offset, h.end + offset, h.frames, h.live, h.text)
            for h in list(calls.host) if h0 <= h.start < h1]
    return Trace(records, t0, t1, offset, host)


class Utilization:
    """The card's utilization counter, sampled by ``nvidia-smi`` every
    200 ms from ``start`` to ``stop`` (module docstring)."""

    def __init__(self, index: int = 0):
        self.index = index
        self.samples: List[Tuple[float, float]] = []  # (perf_counter when read, percent)
        self._proc = self._reader = None

    def start(self) -> "Utilization":
        try:
            self._proc = subprocess.Popen(
                ["nvidia-smi", "--query-gpu=utilization.gpu", "--format=csv,noheader,nounits",
                 "-i", str(self.index), "-lms", "200"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        except OSError:
            return self
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()
        atexit.register(self.stop)  # a run that fails leaves no sampler behind
        return self

    def _read(self) -> None:
        for line in self._proc.stdout:
            try:
                self.samples.append((time.perf_counter(), float(line.strip())))
            except ValueError:
                continue

    def stop(self) -> None:
        if self._proc is None or self._proc.returncode is not None:
            return
        self._proc.terminate()
        try:
            self._proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self._proc.kill()
            self._proc.wait()
        self._reader.join(timeout=10)

    def busy_pct(self, t0: float, t1: float) -> Optional[float]:
        """The mean of the samples that cover (t0, t1]: each read at the
        end of its period, the first period after ``t0`` left out."""
        xs = [u for t, u in self.samples if t0 + 0.2 < t <= t1]
        return sum(xs) / len(xs) if xs else None
