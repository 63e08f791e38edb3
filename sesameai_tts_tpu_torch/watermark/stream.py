"""Streaming watermark embedding for PCM streams (port of
``sesameai_tts_tpu/watermark/stream.py``).

The offline embed (``watermark/dsp.py``) marks a whole clip at once; this
module streams the same spread-spectrum scheme chunk by chunk, so a
streamed HTTP response carries one continuous mark from its first chunk:

* ``StreamingResampler`` (``audio/resample.py``) converts 24 k ↔ 44.1 kHz
  with the samples of the offline ``resample``, so no chunk has edges;
* ``StreamingEmbedder`` runs the STFT chip embedding frame by frame with a
  4-frame lookahead: the emitted stream is one continuous watermark grid
  (same grid phase, same overlap-add normalization as the offline embed of
  the same prefix), and every prefix of 4 s or more verifies;
* ``StreamingWatermarker`` chains resample → embed → resample for the
  service layer (24 kHz PCM chunks in, 24 kHz marked PCM out).

Pipeline latency is ~95 ms of audio (the lookahead, one STFT window and the
resamplers' half filters).  The embedder is numpy on the host on purpose:
each block is microseconds of host FFT.

``StreamingNetEmbedder`` and ``make_streaming_net_watermarker`` stream the
learned silentcipher network in the JAX package; that network is not
ported (``watermark/api.py``), so here they raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from sesameai_tts_tpu_torch.audio.resample import StreamingResampler
from sesameai_tts_tpu_torch.watermark.dsp import (
    _BIN_HI,
    _BIN_LO,
    _BLOCK_F,
    _BLOCK_T,
    _EDGE_FRAMES,
    HOP,
    N_BYTES,
    N_CODES,
    N_FFT,
    P_TIME,
    WATERMARK_RATE,
    Watermarker,
    _prn,
)

_FR = 4  # frames per processing block (a multiple of _BLOCK_T; small, so the
#          first marked samples leave after ~130 ms of input)
_LOOKAHEAD = _EDGE_FRAMES  # frames of lookahead, so feed() never marks a
#                            frame that could end up among the final 4


def _chip_signs_np(message: np.ndarray, f0: int, frames: int) -> np.ndarray:
    """±1 chips for absolute frames [f0, f0+frames): ``dsp._chip_signs`` with
    an absolute frame offset (the grid repeats in time, so a stream marked
    block by block at the right offset equals one offline embed)."""
    nbins = _BIN_HI - _BIN_LO
    nbf = (nbins + _BLOCK_F - 1) // _BLOCK_F
    bt = ((f0 + np.arange(frames))[:, None] // _BLOCK_T) % P_TIME
    bf = np.arange(nbins)[None, :] // _BLOCK_F
    block = bt * nbf + bf
    slots = block % N_BYTES
    chips = (block // N_BYTES) % N_CODES
    return _prn()[(chips + message[slots]) % N_CODES]


class StreamingEmbedder:
    """Incremental 44.1 kHz spread-spectrum embed (one continuous grid).

    ``feed`` takes any number of samples and returns every sample whose
    overlap-add is complete; ``close`` flushes the tail with the offline
    edge policy (marks stop at the offline frame bucket minus
    ``_EDGE_FRAMES``, as ``dsp._embed`` applies it)."""

    def __init__(self, message: List[int], message_sdr: float = 30.0):
        self._msg = np.asarray(message, np.int64)
        if self._msg.shape != (N_BYTES,):
            raise ValueError(f"the message has {N_BYTES} bytes, not {self._msg.shape}")
        self._alpha = float(10.0 ** (-message_sdr / 20.0))
        self._win = np.hanning(N_FFT).astype(np.float64)
        self._win2 = self._win * self._win
        self._buf = np.zeros(0, np.float64)  # input; _buf[0] is absolute sample _buf0
        self._buf0 = 0
        self._n_in = 0
        self._f_next = 0  # next frame to process
        # overlap-add carries over absolute samples [_out0, _out0 + len)
        self._ola = np.zeros(0, np.float64)
        self._wsum = np.zeros(0, np.float64)
        self._out0 = 0
        self._closed = False

    def _process_block(self, f0: int, frames: int, mark: np.ndarray, x: np.ndarray) -> None:
        """Embed frames [f0, f0+frames) of x (starting at absolute sample
        f0*HOP, zero past the signal's end) into the overlap-add carry."""
        idx = np.arange(frames)[:, None] * HOP + np.arange(N_FFT)[None, :]
        spec = np.fft.rfft(x[idx] * self._win[None, :], axis=-1)
        signs = _chip_signs_np(self._msg, f0, frames)
        gain = np.ones((frames, N_FFT // 2 + 1))
        gain[:, _BIN_LO:_BIN_HI] = 1.0 + self._alpha * signs * mark[:, None]
        out = np.fft.irfft(spec * gain, n=N_FFT, axis=-1) * self._win[None, :]

        need = (f0 + frames - 1) * HOP + N_FFT - self._out0
        if need > len(self._ola):
            pad = need - len(self._ola)
            self._ola = np.concatenate([self._ola, np.zeros(pad)])
            self._wsum = np.concatenate([self._wsum, np.zeros(pad)])
        for t in range(frames):
            s = (f0 + t) * HOP - self._out0
            self._ola[s:s + N_FFT] += out[t]
            self._wsum[s:s + N_FFT] += self._win2

    def _block_input(self, f0: int, frames: int) -> np.ndarray:
        lo = f0 * HOP
        hi = lo + (frames - 1) * HOP + N_FFT
        x = np.zeros(hi - lo)
        src_lo = max(lo, self._buf0)
        src_hi = min(hi, self._buf0 + len(self._buf))
        if src_hi > src_lo:
            x[src_lo - lo:src_hi - lo] = self._buf[src_lo - self._buf0:src_hi - self._buf0]
        return x

    def _emit_until(self, settled: int) -> np.ndarray:
        n = settled - self._out0
        if n <= 0:
            return np.zeros(0, np.float32)
        out = self._ola[:n] / np.maximum(self._wsum[:n], 1e-8)
        self._ola = self._ola[n:]
        self._wsum = self._wsum[n:]
        self._out0 = settled
        # input before the next frame's window start is no longer needed
        keep_from = self._f_next * HOP
        if keep_from > self._buf0:
            self._buf = self._buf[keep_from - self._buf0:]
            self._buf0 = keep_from
        return out.astype(np.float32)

    def feed(self, x: np.ndarray) -> np.ndarray:
        if self._closed:
            raise RuntimeError("feed after close")
        self._buf = np.concatenate([self._buf, np.asarray(x, np.float64)])
        self._n_in += len(x)
        # a block is safe once _LOOKAHEAD more full frames exist past it
        while (self._f_next + _FR - 1 + _LOOKAHEAD) * HOP + N_FFT <= self._n_in:
            f0 = self._f_next
            mark = ((f0 + np.arange(_FR)) >= _EDGE_FRAMES).astype(np.float64)
            self._process_block(f0, _FR, mark, self._block_input(f0, _FR))
            self._f_next += _FR
        return self._emit_until(self._f_next * HOP)

    def close(self) -> np.ndarray:
        """Process the remaining frames and flush every remaining real
        sample.  Marks stop where the offline embed's stop (frames <
        bucket - _EDGE_FRAMES, the offline embed padding the frame count to
        a power of two), so a short captured suffix is marked as offline."""
        if self._closed:
            raise RuntimeError("close after close")
        self._closed = True
        L = self._n_in
        if L == 0:
            return np.zeros(0, np.float32)
        f_total = (L - 1) // HOP + 1  # every real sample covered 4×
        nf_off = max(1, 1 + (L - N_FFT) // HOP) if L >= N_FFT else 1
        bucket = 1 << (nf_off - 1).bit_length()  # dsp._pad_to_frames
        while self._f_next < f_total:
            f = np.arange(self._f_next, self._f_next + _FR)
            mark = ((f >= _EDGE_FRAMES) & (f < bucket - _EDGE_FRAMES)).astype(np.float64)
            self._process_block(self._f_next, _FR, mark, self._block_input(self._f_next, _FR))
            self._f_next += _FR
        return self._emit_until(L)


class _ResampleEmbedPipe:
    """``io_rate`` PCM in → ``io_rate`` marked PCM out, chunk by chunk,
    through an embedder at ``embed_rate``: sample for sample one continuous
    resample → embed → resample pipeline, so any prefix long enough to
    carry the mark verifies with the offline verifier
    (``watermark/api.py::verify``)."""

    def __init__(self, embedder, embed_rate: int, io_rate: int):
        self._up = StreamingResampler(io_rate, embed_rate) if io_rate != embed_rate else None
        self._emb = embedder
        self._down = StreamingResampler(embed_rate, io_rate) if io_rate != embed_rate else None

    def feed(self, pcm: np.ndarray) -> np.ndarray:
        x = self._up.feed(pcm) if self._up else np.asarray(pcm, np.float32)
        y = self._emb.feed(x)
        return self._down.feed(y) if self._down else y

    def close(self) -> np.ndarray:
        x = self._up.close() if self._up else np.zeros(0, np.float32)
        y = np.concatenate([self._emb.feed(x), self._emb.close()])
        if not self._down:
            return y
        return np.concatenate([self._down.feed(y), self._down.close()])


class StreamingWatermarker(_ResampleEmbedPipe):
    """24 kHz PCM in → 24 kHz watermarked PCM out (the DSP scheme)."""

    def __init__(self, message: List[int], io_rate: int, message_sdr: float = 30.0):
        super().__init__(StreamingEmbedder(message, message_sdr), WATERMARK_RATE, io_rate)


def make_streaming_watermarker(watermarker, key: List[int], io_rate: int,
                               message_sdr: Optional[float] = None):
    """The streaming pipeline of a watermark backend: the DSP
    ``Watermarker``'s, else None (the caller then marks ≥ 4 s groups)."""
    if isinstance(watermarker, Watermarker):
        if message_sdr is None:
            message_sdr = getattr(watermarker, "default_message_sdr", 30.0)
        return StreamingWatermarker(key, io_rate, message_sdr)
    return None


_NET_MISSING = ("the learned silentcipher watermark network (watermark/net.py of the JAX "
                "package) is not ported to PyTorch yet (ROADMAP A12); stream with the DSP "
                "scheme (load_watermarker())")


class StreamingNetEmbedder:
    """The silentcipher network's streaming embed; not ported (ROADMAP A12)."""

    def __init__(self, model, message, message_sdr: Optional[float] = None,
                 alpha: Optional[float] = None):
        raise NotImplementedError(_NET_MISSING)


def make_streaming_net_watermarker(model, key, io_rate: int,
                                   message_sdr: Optional[float] = None):
    """The silentcipher network's streaming pipeline; not ported (ROADMAP A12)."""
    raise NotImplementedError(_NET_MISSING)
