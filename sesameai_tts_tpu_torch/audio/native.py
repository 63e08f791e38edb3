"""ctypes bindings for the native audio kernels (port of
``sesameai_tts_tpu/audio/native.py``; the C++ is ``native/audio.cpp`` at
the repository root, built by ``native/build.py`` with ``g++`` at first
use).  Every entry point is a sample-exact equivalent of its numpy
counterpart in ``audio/resample.py`` / ``audio/segment.py``.

These are an alternative host backend, not the default path: the
product's ``resample()`` stays on scipy because the streaming
resampler's bit-identical-to-offline contract (``watermark/stream.py``
depends on it) is defined against scipy's ``upfirdn``; mixing backends
within one pipeline would break it.  Deployments without scipy can call
these directly.  ``available()`` is False where the library cannot be
built (no ``g++``)."""

from __future__ import annotations

import ctypes
import os
import sys
from functools import lru_cache
from typing import Optional

import numpy as np

from sesameai_tts_tpu_torch.audio.resample import _resample_plan


@lru_cache(maxsize=1)
def _lib() -> Optional[ctypes.CDLL]:
    root = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
    if root not in sys.path:
        sys.path.insert(0, root)
    try:
        from native.build import build  # repo-root native/, outside both packages

        lib = ctypes.CDLL(build("audio"))
    except Exception:  # no compiler, no source: the backend is unavailable
        return None
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i16p = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
    i64 = ctypes.c_int64
    for name, args in (("resample_poly", [f32p, i64, f32p, i64, i64, i64, f32p, i64]),
                       ("apply_fade", [f32p, i64, i64, i64]),
                       ("f32_to_i16", [f32p, i64, i16p]),
                       ("i16_to_f32", [i16p, i64, f32p]),
                       ("peak_normalize", [f32p, i64, ctypes.c_float])):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = None
    return lib


def available() -> bool:
    return _lib() is not None


def _require() -> ctypes.CDLL:
    lib = _lib()
    if lib is None:
        raise RuntimeError("native audio library unavailable (use AudioClip / resample)")
    return lib


def resample_native(x: np.ndarray, orig_rate: int, new_rate: int) -> np.ndarray:
    """Polyphase resample via the C++ kernel; the same filter design as the
    scipy path (``audio/resample.py``)."""
    lib = _require()
    if orig_rate == new_rate:
        return x
    up, down, taps = _resample_plan(orig_rate, new_rate)
    x = np.ascontiguousarray(x, np.float32)
    n_out = -(-len(x) * up // down)
    out = np.empty(n_out, np.float32)
    lib.resample_poly(x, len(x), np.ascontiguousarray(taps), len(taps), up, down, out, n_out)
    return out


def fade_inplace(x: np.ndarray, fade_in_n: int, fade_out_n: int) -> np.ndarray:
    lib = _require()
    x = np.ascontiguousarray(x, np.float32)
    lib.apply_fade(x, len(x), fade_in_n, fade_out_n)
    return x


def to_int16(x: np.ndarray) -> np.ndarray:
    lib = _require()
    x = np.ascontiguousarray(x, np.float32)
    out = np.empty(len(x), np.int16)
    lib.f32_to_i16(x, len(x), out)
    return out


def peak_normalize_inplace(x: np.ndarray, peak: float = 1.0) -> np.ndarray:
    lib = _require()
    x = np.ascontiguousarray(x, np.float32)
    lib.peak_normalize(x, len(x), peak)
    return x
