"""Host polyphase resampling (port of the host half of
``sesameai_tts_tpu/audio/resample.py``): a Kaiser-windowed-sinc lowpass at
the reduced rational ratio, applied with scipy's ``resample_poly``.  The
on-device ``resample_jax`` and the ``StreamingResampler`` serve the
watermark path and are not ported yet.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np


def _design_filter(up: int, down: int, num_zeros: int = 24, beta: float = 9.90322):
    """Kaiser-windowed sinc lowpass at cutoff min(1/up, 1/down)."""
    max_rate = max(up, down)
    cutoff = 0.5 / max_rate  # normalized to the upsampled rate
    half_len = num_zeros * max_rate
    n = np.arange(-half_len, half_len + 1, dtype=np.float64)
    taps = 2 * cutoff * np.sinc(2 * cutoff * n) * np.kaiser(len(n), beta)
    return (taps * up).astype(np.float32)


@lru_cache(maxsize=64)
def _resample_plan(orig_rate: int, new_rate: int):
    g = math.gcd(orig_rate, new_rate)
    up, down = new_rate // g, orig_rate // g
    return up, down, _design_filter(up, down)


def resample(x: np.ndarray, orig_rate: int, new_rate: int) -> np.ndarray:
    """(T,) float32 → resampled (ceil(T*new/orig),) float32."""
    if orig_rate == new_rate:
        return x
    up, down, taps = _resample_plan(orig_rate, new_rate)
    from scipy.signal import resample_poly

    return resample_poly(x.astype(np.float64), up, down, window=taps / up).astype(
        np.float32
    )
