"""Polyphase resampling (port of ``sesameai_tts_tpu/audio/resample.py``):
a Kaiser-windowed-sinc lowpass at the reduced rational ratio.

- ``resample``: on the host, with scipy's ``resample_poly``;
- ``resample_device``: on a tensor's device (the JAX package's
  ``resample_jax``), one strided convolution over the zero-stuffed input;
- ``StreamingResampler``: chunk by chunk on the host, its output
  bit-identical to ``resample`` of the concatenated input (the streaming
  watermark's 24 k ↔ 44.1 kHz hops).
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F


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


def resample_device(x: torch.Tensor, orig_rate: int, new_rate: int) -> torch.Tensor:
    """(..., T) → (..., ceil(T*up/down)) float32 on x's device: zero-stuff by
    ``up``, then one f32 convolution with the filter at stride ``down``,
    centred as ``resample`` (the JAX package's ``conv_general_dilated`` with
    ``lhs_dilation=up``).  No host round trip."""
    if orig_rate == new_rate:
        return x
    up, down, taps = _resample_plan(orig_rate, new_rate)
    T = x.shape[-1]
    out_len = -(-T * up // down)  # ceil
    half = (len(taps) - 1) // 2
    xb = x.reshape(-1, 1, T).float()
    stuffed = xb.new_zeros((xb.shape[0], 1, (T - 1) * up + 1))
    stuffed[..., ::up] = xb
    padded = F.pad(stuffed, (half, half + down * out_len - T * up + up - 1))
    w = torch.from_numpy(taps).to(x.device)[None, None, :]
    y = F.conv1d(padded, w, stride=down)
    return y[:, 0, :out_len].reshape(x.shape[:-1] + (out_len,))


class StreamingResampler:
    """Stateful polyphase resampler: ``feed`` chunks, get the settled output.

    Gives the same samples, bit for bit, as ``resample`` of the concatenated
    input (same filter, same centring): output j is
    ``conv(taps, zero-stuffed x)[j*down + half]``, emitted once every input
    sample its filter support touches has arrived.  Latency: ``half/up``
    input samples (~1 ms at the watermark rates)."""

    def __init__(self, orig_rate: int, new_rate: int):
        if orig_rate == new_rate:
            raise ValueError("StreamingResampler needs two different rates")
        self.up, self.down, self.taps = _resample_plan(orig_rate, new_rate)
        # the filter exactly as ``resample`` hands it to scipy (taps / up,
        # which resample_poly scales back by up in f32): a filter one ulp
        # away would move outputs by an ulp
        h = self.taps / self.up
        h *= self.up
        self._taps64 = h.astype(np.float64)
        self.L = len(self.taps)
        self.half = (self.L - 1) // 2
        self._buf = np.zeros(0, np.float64)
        self._start = 0  # absolute input index of _buf[0]
        self._j = 0  # next output index
        self._n_in = 0

    def feed(self, x: np.ndarray) -> np.ndarray:
        """Append input samples; return every newly settled output sample."""
        self._buf = np.concatenate([self._buf, np.asarray(x, np.float64)])
        self._n_in += len(x)
        # settled: j*down + half < up*n_in (no later input touches them)
        j_end = (self.up * self._n_in - self.half - 1) // self.down + 1
        return self._drain(j_end)

    def close(self) -> np.ndarray:
        """Flush the tail, completing ceil(n_in*up/down) outputs (the
        length of ``resample``)."""
        return self._drain(-(-self._n_in * self.up // self.down))

    def _drain(self, j_end: int) -> np.ndarray:
        from scipy.signal import upfirdn

        if j_end <= self._j:
            return np.zeros(0, np.float32)
        # drop the input no output >= j still needs
        lo = max(0, (self._j * self.down + self.half - self.L + 1) // self.up)
        if lo > self._start:
            self._buf = self._buf[lo - self._start:]
            self._start = lo
        z = upfirdn(self._taps64, self._buf, self.up, 1)
        m = np.arange(self._j, j_end) * self.down + self.half - self.up * self._start
        out = np.zeros(j_end - self._j)
        ok = (m >= 0) & (m < len(z))
        out[ok] = z[m[ok]]
        self._j = j_end
        return out.astype(np.float32)
