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

* ``StreamingNetEmbedder`` streams the silentcipher network
  (``watermark/net.py``) the same way: exact overlap-save over the conv
  stacks' receptive field, each block's network on the watermarker's
  device, the overlap-add on the host.

Pipeline latency is ~95 ms of audio for the DSP scheme (the lookahead, one
STFT window and the resamplers' half filters).  Its embedder is numpy on
the host on purpose: each block is microseconds of host FFT.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

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
    _irfft,
    _prn,
    _rfft,
)
from sesameai_tts_tpu_torch.watermark.net import (
    NetWatermarker,
    _bucket_frames,
    _resid_spec,
    _stack_halfwidth,
    _window,
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
    ``Watermarker``'s or the silentcipher ``NetWatermarker``'s, else None
    (the caller then marks ≥ 4 s groups)."""
    if isinstance(watermarker, Watermarker):
        if message_sdr is None:
            message_sdr = getattr(watermarker, "default_message_sdr", 30.0)
        return StreamingWatermarker(key, io_rate, message_sdr)
    return make_streaming_net_watermarker(watermarker, key, io_rate, message_sdr)


# ---------------------------------------------------------------------------
# Streaming embed through the silentcipher network
#
# The network's residual at STFT frame t depends on the magnitude frames
# [t-L, t+L] only (L = Σ kw//2 over the enc_c and dec_c stacks) and on the
# frame's own phase, so overlap-save streaming is exact: each block runs
# with L real context frames on both sides and keeps its centre.  The
# offline bucket's zero-audio frames are reproduced by zero samples past
# the stream's end (the network sees zero-input frames there, which is not
# the conv's zero padding beyond the first layer: biases flow), and the
# offline conv's end by masking every layer at the bucket (``valid_t``).
# The one difference from the offline ``encode_wav`` is α: offline solves
# the message-SDR gain over the whole clip, the stream over the energies
# emitted so far (it settles within the first seconds).
# ---------------------------------------------------------------------------


def _net_receptive_halfwidth(params: dict) -> int:
    return _stack_halfwidth(params["enc_c"]) + _stack_halfwidth(params["dec_c"])


def _net_block_segs(model, xseg: np.ndarray, message: torch.Tensor, frames: int,
                    keep_lo: int, valid_t: int) -> np.ndarray:
    """The windowed residual frames [keep_lo, frames) of one block: xseg
    holds the block's ``frames`` STFT windows (context included), in the
    reflect-padded coordinates of the offline STFT."""
    cfg, params, dev = model.cfg, model.params, model.device
    win = _window(cfg.n_fft, dev)
    segs = torch.from_numpy(xseg).to(dev).unfold(0, cfg.n_fft, cfg.hop)[:frames]
    spec = _rfft(segs * win)
    mag = spec.abs()
    # the offline convs run on exactly the bucket's frames and zero-pad past
    # it; valid_t reproduces that end where this block reaches past it
    t_mask = (torch.arange(frames, device=dev) < valid_t).float()[None, None, None, :]
    resid = _resid_spec(params, mag, message, t_mask)  # (frames, n_bins)
    out = _irfft(resid * (spec / (mag + 1e-8)), cfg.n_fft) * win
    return out[keep_lo:].cpu().numpy().astype(np.float64)


class StreamingNetEmbedder:
    """Incremental embed through the silentcipher network, at its rate.

    ``feed`` / ``close`` as ``StreamingEmbedder``'s; every block of
    ``_BLOCK`` frames runs the network once on the watermarker's device.
    ``alpha`` pins the embed gain (for exactness checks); by default the
    gain follows the cumulative signal and residual energies (offline
    solves it over the whole clip)."""

    _BLOCK = 32  # frames per block

    def __init__(self, model, message, message_sdr: Optional[float] = None,
                 alpha: Optional[float] = None):
        if not isinstance(model, NetWatermarker):
            raise TypeError(f"StreamingNetEmbedder streams a silentcipher NetWatermarker, "
                            f"not {type(model).__name__}")
        self._model = model
        cfg = model.cfg
        self._pad = cfg.n_fft // 2
        self._hop = cfg.hop
        self._n_fft = cfg.n_fft
        self._L = _net_receptive_halfwidth(model.params)
        self._msg = torch.tensor(np.asarray(message, np.int64), device=model.device)
        sdr = cfg.default_message_sdr if message_sdr is None else message_sdr
        self._gain = 10.0 ** (-sdr / 20.0)
        self._alpha_fixed = alpha
        win = np.hanning(cfg.n_fft + 1)[:-1].astype(np.float32)
        self._win2 = (win * win).astype(np.float64)

        # the input in output coordinates, trimmed as frames and emission drain
        self._xin = np.zeros(0, np.float32)
        self._xin0 = 0
        self._n_in = 0
        self._head: Optional[np.ndarray] = None  # the offline reflect pad
        self._endpad: Optional[np.ndarray] = None  # the offline END reflect pad
        self._end0 = 0  # xpad coordinate where the end reflection begins
        self._fmax: Optional[int] = None  # the offline frame count (close only)
        self._f_done = 0
        self._ola = np.zeros(0, np.float64)  # residual overlap-add from _out0 (xpad coords)
        self._wsum = np.zeros(0, np.float64)
        self._out0 = 0
        self._emitted = 0
        self._cum_sig = 0.0
        self._cum_noise = 0.0
        self._closed = False

    def _xpad_slice(self, lo: int, hi: int) -> np.ndarray:
        """xpad[lo:hi], xpad = reflect_head(pad) + input + zeros to the frame
        bucket + reflect_end(pad): the signal the offline STFT frames see
        (the end reflection exists once close() has fixed the length)."""
        out = np.zeros(hi - lo, np.float32)
        h_lo, h_hi = max(lo, 0), min(hi, self._pad)
        if h_hi > h_lo:
            out[h_lo - lo:h_hi - lo] = self._head[h_lo:h_hi]
        x_lo = max(lo, self._pad)
        x_hi = min(hi, self._pad + self._n_in)
        if x_hi > x_lo:
            a = x_lo - self._pad - self._xin0
            out[x_lo - lo:x_hi - lo] = self._xin[a:a + (x_hi - x_lo)]
        if self._endpad is not None and hi > self._end0:
            e_lo, e_hi = max(lo, self._end0), min(hi, self._end0 + self._pad)
            if e_hi > e_lo:
                out[e_lo - lo:e_hi - lo] = self._endpad[e_lo - self._end0:e_hi - self._end0]
        return out

    def _process_blocks(self, f_end: Optional[int]) -> None:
        """Run frame blocks: with f_end None only blocks whose ±L context
        has arrived, else every block through frame f_end, with zero context
        past the stream's end (the offline bucket's padding)."""
        hop, n_fft, L, B = self._hop, self._n_fft, self._L, self._BLOCK
        while True:
            a = self._f_done
            if f_end is not None and a >= f_end:
                return
            # blocks are always B frames; frames past f_end read zero samples
            # and write overlap-add only beyond the emitted range
            b = a + B
            hi_sample = (b + L - 1) * hop + n_fft  # xpad coordinates
            if f_end is None and hi_sample > self._pad + self._n_in:
                return
            lo_f = max(0, a - L)
            seg = self._xpad_slice(lo_f * hop, hi_sample)
            n_frames = b + L - lo_f
            valid_t = min(self._fmax - lo_f, n_frames) if self._fmax is not None else n_frames
            out = _net_block_segs(self._model, seg, self._msg, n_frames, a - lo_f,
                                  valid_t)[:b - a]
            need = (b - 1) * hop + n_fft - self._out0
            if need > len(self._ola):
                grow = need - len(self._ola)
                self._ola = np.concatenate([self._ola, np.zeros(grow)])
                self._wsum = np.concatenate([self._wsum, np.zeros(grow)])
            for t in range(b - a):
                if self._fmax is not None and (a + t) >= self._fmax:
                    continue  # offline has exactly _fmax frames: block-fill
                    # frames past it stay out of the overlap-add (they
                    # overlap the emitted tail when the bucket equals nf)
                s = (a + t) * hop - self._out0
                self._ola[s:s + n_fft] += out[t]
                self._wsum[s:s + n_fft] += self._win2
            self._f_done = b

    def _emit_ready(self) -> np.ndarray:
        """y = x + α·resid for the settled output samples; trim the buffers."""
        settled = min(self._f_done * self._hop - self._pad, self._n_in)
        n = settled - self._emitted
        if n <= 0:
            return np.zeros(0, np.float32)
        lo = self._emitted + self._pad - self._out0
        resid = self._ola[lo:lo + n] / np.maximum(self._wsum[lo:lo + n], 1e-8)
        xs = self._xin[self._emitted - self._xin0:settled - self._xin0]
        self._cum_sig += float(np.sum(xs.astype(np.float64) ** 2))
        self._cum_noise += float(np.sum(resid ** 2))
        alpha = (self._alpha_fixed if self._alpha_fixed is not None
                 else self._gain * np.sqrt(self._cum_sig / max(self._cum_noise, 1e-20)))
        y = (xs + alpha * resid).astype(np.float32)
        drop = self._emitted + self._pad - self._out0 + n
        self._ola = self._ola[drop:]
        self._wsum = self._wsum[drop:]
        self._out0 += drop
        self._emitted = settled
        # keep the input that later frames or emission still need
        keep = min(self._emitted, max(0, (self._f_done - self._L) * self._hop - self._pad))
        if keep > self._xin0:
            self._xin = self._xin[keep - self._xin0:]
            self._xin0 = keep
        return y

    def feed(self, x: np.ndarray) -> np.ndarray:
        if self._closed:
            raise RuntimeError("feed after close")
        x = np.asarray(x, np.float32)
        self._xin = np.concatenate([self._xin, x])
        self._n_in += len(x)
        if self._head is None:
            if self._n_in < self._pad + 1:
                return np.zeros(0, np.float32)
            first = self._xin[:self._pad + 1]  # _xin0 == 0 before any trim
            self._head = first[1:][::-1].copy()  # np.pad reflect semantics
        self._process_blocks(None)
        return self._emit_ready()

    def close(self) -> np.ndarray:
        if self._closed:
            raise RuntimeError("close after close")
        self._closed = True
        if self._n_in == 0:
            return np.zeros(0, np.float32)
        if self._head is None:  # shorter than one pad: offline zero-pads the
            # clip to the frame bucket before reflecting
            ext = np.pad(self._xin, (0, self._pad + 1 - self._n_in))
            self._head = ext[1:][::-1].copy()
        nf = 1 + self._n_in // self._hop
        self._fmax = _bucket_frames(nf)  # the offline frame count
        need = self._fmax * self._hop
        # offline reflect-pads xp = input + zeros(need - n) at the end:
        # xpad[pad+need+i] = xp[need-2-i]; when the zero gap is < pad (1+n//hop
        # exactly a power of two) the reflection mirrors real samples
        idx = need - 2 - np.arange(self._pad)
        vals = np.zeros(self._pad, np.float32)
        real = (idx >= self._xin0) & (idx < self._n_in)
        if real.any():
            vals[real] = self._xin[idx[real] - self._xin0]
        self._endpad = vals
        self._end0 = self._pad + need
        f_end = nf + -(-self._pad // self._hop)  # covers every real sample
        self._process_blocks(max(f_end, self._f_done))
        return self._emit_ready()


def make_streaming_net_watermarker(model, key, io_rate: int,
                                   message_sdr: Optional[float] = None):
    """resample → network embed → resample for a silentcipher
    ``NetWatermarker``, else None."""
    if not isinstance(model, NetWatermarker):
        return None
    return _ResampleEmbedPipe(StreamingNetEmbedder(model, key, message_sdr),
                              model.cfg.sample_rate, io_rate)
