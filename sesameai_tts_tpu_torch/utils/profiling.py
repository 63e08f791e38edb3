"""Structured per-stage metrics (port of ``Metrics`` from
``sesameai_tts_tpu/utils/profiling.py``)."""

from __future__ import annotations

import threading
from collections import defaultdict
from typing import Dict, List

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
