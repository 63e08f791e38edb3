"""Profiling and structured metrics (port of
``sesameai_tts_tpu/utils/profiling.py``): bounded per-stage metric series,
a ``torch.profiler`` trace context for device timelines, and realtime
factor accounting for one utterance.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional

import numpy as np


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

    def reset(self) -> None:
        with self._lock:
            self._series.clear()


@contextlib.contextmanager
def device_trace(logdir: str) -> Iterator[None]:
    """Trace the CPU and, where there is a card, the CUDA timeline of the
    block with ``torch.profiler``; the Chrome trace (Perfetto,
    chrome://tracing) is written into ``logdir`` when the block ends."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


@dataclass
class RTFMeter:
    """Realtime-factor accounting for one utterance: feed it the PCM chunks
    as they arrive, then read ``result()``."""

    sample_rate: int
    start: float = field(default_factory=time.perf_counter)
    first_audio_at: Optional[float] = None
    samples: int = 0

    def on_chunk(self, chunk: np.ndarray) -> None:
        if self.first_audio_at is None:
            self.first_audio_at = time.perf_counter() - self.start
        self.samples += len(chunk)

    def result(self) -> dict:
        proc = time.perf_counter() - self.start
        audio_s = self.samples / self.sample_rate
        return {
            "proc_s": proc,
            "audio_s": audio_s,
            "rtf": proc / audio_s if audio_s else float("inf"),
            "xrt": audio_s / proc if proc else 0.0,
            "first_audio_ms": (self.first_audio_at or 0.0) * 1000.0,
        }
