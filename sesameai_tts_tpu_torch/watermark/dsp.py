"""Audio watermark: STFT-domain spread spectrum, embedded and verified on
the device with torch ops (port of ``sesameai_tts_tpu/watermark/dsp.py``).

The scheme, its constants and its thresholds are the JAX package's, so
each package verifies the other's marks:

* payload: 5 bytes; byte slot s owns every 5th block of STFT cells;
  within a slot, blocks cycle through 256 chip classes; byte value v
  selects the cyclic shift of a fixed ±1 PRN sequence, so a blind decode
  of all 256 values of a slot is one circular correlation;
* embed: ``M' = M · (1 + α·chip)`` on bins 300 Hz–10.5 kHz at 44.1 kHz,
  α from ``message_sdr`` (dB below the signal), the 4 edge frames of the
  padded signal unmodified;
* decode: log magnitude minus its local box-blurred mean, clipped, then
  per-(slot, chip class) means and their circular correlation with the
  PRN; ``phase_shift_decoding`` searches 16 sub-hop offsets × 11 grid row
  phases.

The signal is padded to a power-of-two frame bucket, as in the JAX
package: the unmodified edge frames sit at the end of the bucket, so the
marked samples near the end depend on it.

The overlap-add divides by Σ win², which falls below 1e-6 within the
first ~20 samples, so the FFT's rounding there is amplified ~1e4 times
and two FFT libraries give marked samples ~1e-4 of the peak apart.  On a
CUDA tensor the FFTs are torch's (cuFFT); on a CPU tensor they go
through ``scipy.fft``, the pocketfft algorithm of the JAX package's CPU
backend, so there the two packages agree to float rounding everywhere.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# the public CSM watermark key (public, not secret)
CSM_1B_WATERMARK = [212, 211, 146, 56, 201]
CSM_1B_GH_WATERMARK = CSM_1B_WATERMARK

WATERMARK_RATE = 44_100
N_FFT = 2048
HOP = 512
N_BYTES = 5
N_CODES = 256
_BIN_LO = int(300 * N_FFT / WATERMARK_RATE)  # ≈ 300 Hz
_BIN_HI = int(10_500 * N_FFT / WATERMARK_RATE)  # ≈ 10.5 kHz
_PRN_SEED = 1830293  # fixed and public, as the JAX package's

_BLOCK_T = 4  # chip blocks span 4 frames × 4 bins: with 75 % STFT overlap
_BLOCK_F = 4  # neighbouring frames carry the same chip, so overlap-add keeps it
P_TIME = 11  # the chip grid repeats every 11 block rows (≈ 0.51 s)
_EDGE_FRAMES = 4  # STFT edges stay unmodified (1/Σwin² amplifies changes there)


@lru_cache(maxsize=1)
def _prn() -> np.ndarray:
    rng = np.random.default_rng(_PRN_SEED)
    return (rng.integers(0, 2, N_CODES) * 2 - 1).astype(np.float32)


@lru_cache(maxsize=None)
def _window(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.hanning(N_FFT).astype(np.float32)).to(device)


def _grid(frames: int, phase, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-cell (slot, chip class) of ``frames`` STFT frames, the block-row
    index shifted by ``phase`` (an int, or a (P, 1, 1) tensor of phases)."""
    nbins = _BIN_HI - _BIN_LO
    nbf = (nbins + _BLOCK_F - 1) // _BLOCK_F
    bt = (torch.arange(frames, device=device)[:, None] // _BLOCK_T + phase) % P_TIME
    bf = torch.arange(nbins, device=device)[None, :] // _BLOCK_F
    block = bt * nbf + bf
    return block % N_BYTES, (block // N_BYTES) % N_CODES


def _rfft(x: torch.Tensor) -> torch.Tensor:
    """rfft over the last dim (see the module docstring for the CPU route)."""
    if x.device.type != "cpu":
        return torch.fft.rfft(x, dim=-1)
    import scipy.fft

    return torch.from_numpy(scipy.fft.rfft(x.numpy(), axis=-1))


def _irfft(x: torch.Tensor, n: int) -> torch.Tensor:
    if x.device.type != "cpu":
        return torch.fft.irfft(x, n=n, dim=-1)
    import scipy.fft

    return torch.from_numpy(scipy.fft.irfft(x.numpy(), n=n, axis=-1))


def _stft(x: torch.Tensor, frames: int) -> torch.Tensor:
    segs = x.unfold(0, N_FFT, HOP)[:frames]
    return _rfft(segs * _window(x.device))  # (frames, N_FFT//2+1)


def _istft(spec: torch.Tensor, length: int) -> torch.Tensor:
    """Windowed overlap-add of the frames, normalized by Σ win², as one
    scatter-add over every frame's samples."""
    win = _window(spec.device)
    frames = spec.shape[0]
    segs = _irfft(spec, N_FFT) * win
    idx = (torch.arange(frames, device=spec.device)[:, None] * HOP
           + torch.arange(N_FFT, device=spec.device)).reshape(-1)
    out = torch.zeros(length + N_FFT, device=spec.device).index_add_(0, idx, segs.reshape(-1))
    wsum = torch.zeros(length + N_FFT, device=spec.device).index_add_(
        0, idx, (win * win).expand(frames, N_FFT).reshape(-1))
    return (out / wsum.clamp_min(1e-8))[:length]


def _chip_signs(message: torch.Tensor, frames: int) -> torch.Tensor:
    """±1 chip per (frame, bin) cell given the 5-byte message."""
    slots, chips = _grid(frames, 0, message.device)
    prn = torch.from_numpy(_prn()).to(message.device)
    return prn[(chips + message[slots]) % N_CODES]


def _embed(x: torch.Tensor, message: torch.Tensor, alpha: float, frames: int) -> torch.Tensor:
    """The marked signal; ``alpha`` is a float32 value."""
    spec = _stft(x, frames)
    signs = _chip_signs(message, frames)
    t = torch.arange(frames, device=x.device)
    interior = ((t >= _EDGE_FRAMES) & (t < frames - _EDGE_FRAMES))[:, None].float()
    gain = torch.ones(spec.shape, device=x.device)
    gain[:, _BIN_LO:_BIN_HI] = 1.0 + alpha * signs * interior
    return _istft(spec * gain, x.shape[0])


def _box_blur(x: torch.Tensor, k: int = 17) -> torch.Tensor:
    """Separable local mean over (frames, bins), renormalized at the edges."""
    kernel = torch.ones(1, 1, k, device=x.device, dtype=x.dtype)

    def blur1d(v, dim):
        mv = v.movedim(dim, -1)
        y = F.conv1d(mv.reshape(-1, 1, mv.shape[-1]), kernel, padding=k // 2)
        return y.reshape(mv.shape).movedim(-1, dim)

    return blur1d(blur1d(x, 0), 1) / blur1d(blur1d(torch.ones_like(x), 0), 1)


def _slot_scores(x: torch.Tensor, frames: int, valid_frames: int) -> torch.Tensor:
    """→ (P_TIME, N_BYTES, N_CODES) z-scored correlations, one slice per
    grid row phase.  Frames past ``valid_frames`` (bucket padding) stay out
    of the class means."""
    spec = _stft(x, frames)
    logm = torch.log(spec[:, _BIN_LO:_BIN_HI].abs() + 1e-8)
    # speech log-magnitude residuals are heavy-tailed, the mark is ≤ ~0.03
    # nat: clipping at ±0.3 keeps the mark and tames the outliers
    resid = (logm - _box_blur(logm)).clamp(-0.3, 0.3)
    t = torch.arange(frames, device=x.device)
    fmask = ((t >= _EDGE_FRAMES) & (t < valid_frames))[:, None].float()
    flat_r = (resid * fmask).reshape(-1)
    flat_w = fmask.expand(resid.shape).reshape(-1)

    # the mean residual per (phase, slot, chip class), every phase at once
    phases = torch.arange(P_TIME, device=x.device)[:, None, None]
    slots, chips = _grid(frames, phases, x.device)  # (P, frames, nbins)
    lin = ((phases * N_BYTES + slots) * N_CODES + chips).reshape(-1)
    n = P_TIME * N_BYTES * N_CODES
    sums = torch.zeros(n, device=x.device).index_add_(0, lin, flat_r.repeat(P_TIME))
    cnts = torch.zeros(n, device=x.device).index_add_(0, lin, flat_w.repeat(P_TIME))
    r = (sums / cnts.clamp_min(1.0)).reshape(P_TIME, N_BYTES, N_CODES)
    r = r - r.mean(dim=-1, keepdim=True)

    # score[v] = Σ_c r[c]·prn[(c+v) mod 256] for all v: irfft(R·conj(P))[k]
    # = Σ_c r[c]·prn[c−k], read at k = −v mod 256
    prn = torch.from_numpy(_prn()).to(x.device)
    corr_neg = _irfft(_rfft(r) * _rfft(prn).conj(), N_CODES)
    corr = corr_neg[..., (-torch.arange(N_CODES, device=x.device)) % N_CODES]
    return (corr - corr.mean(dim=-1, keepdim=True)) / (
        corr.std(dim=-1, correction=0, keepdim=True) + 1e-8)


def _pad_to_frames(x: np.ndarray) -> Tuple[np.ndarray, int]:
    """Zero-pad to a power-of-two count of STFT frames → (padded, frames)."""
    frames = max(1, 1 + (len(x) - N_FFT) // HOP if len(x) >= N_FFT else 1)
    bucket = 1 << (frames - 1).bit_length()
    need = N_FFT + (bucket - 1) * HOP
    if len(x) < need:
        x = np.concatenate([x, np.zeros(need - len(x), np.float32)])
    return x, bucket


class Watermarker:
    """``encode_wav`` / ``decode_wav`` as ``silentcipher.server.Model``
    offers them, computed on ``device`` (the card unless the caller asks
    for the CPU).

    With an expected message (verify), the statistic Σ_s z[s, key_s] / √5
    is N(0, 1) under the null for one aligned candidate;
    ``phase_shift_decoding=True`` takes the best of 16 offsets × 11 row
    phases, whose null maximum sits around 3.0-3.7, hence the verify
    threshold 4.0.  A blind decode takes each slot's argmax and holds the
    mean max-z against 3.7."""

    def __init__(self, verify_threshold: float = 4.0, blind_threshold: float = 3.7,
                 device="cuda"):
        from sesameai_tts_tpu_torch.runtime.generator import resolve_device

        self.verify_threshold = verify_threshold
        self.blind_threshold = blind_threshold
        self.device = resolve_device(device)
        self.default_message_sdr = 30.0  # calibrated embed strength of this scheme

    def encode_wav(self, audio: np.ndarray, sample_rate: int, message: List[int],
                   calc_sdr: bool = False, message_sdr: float = 36.0
                   ) -> Tuple[np.ndarray, Optional[float]]:
        if sample_rate != WATERMARK_RATE:
            raise ValueError(f"the embed runs at {WATERMARK_RATE} Hz, not {sample_rate}")
        if len(message) != N_BYTES:
            raise ValueError(f"the message has {N_BYTES} bytes, not {len(message)}")
        x = np.asarray(audio, np.float32).reshape(-1)
        xp, frames = _pad_to_frames(x)
        alpha = float(np.float32(10.0 ** (-message_sdr / 20.0)))
        y = _embed(torch.from_numpy(xp).to(self.device),
                   torch.tensor(message, dtype=torch.int64, device=self.device), alpha, frames)
        y = y[:len(x)].cpu().numpy()
        sdr = None
        if calc_sdr:
            noise = y - x
            sdr = 10.0 * math.log10(float(np.sum(x ** 2)) / max(float(np.sum(noise ** 2)),
                                                                1e-12))
        return y, sdr

    def decode_wav(self, audio: np.ndarray, sample_rate: int,
                   phase_shift_decoding: bool = False,
                   expected_message: Optional[List[int]] = None) -> dict:
        if sample_rate != WATERMARK_RATE:
            raise ValueError(f"the decode runs at {WATERMARK_RATE} Hz, not {sample_rate}")
        x = np.asarray(audio, np.float32).reshape(-1)
        # sub-block-row alignment: HOP/4 steps across one block row; with the
        # P_TIME row phases this re-synchronizes any leading trim
        n_off = 4 * _BLOCK_T if phase_shift_decoding else 1
        best = None
        for off in [i * (HOP // 4) for i in range(n_off)]:
            xo, frames = _pad_to_frames(x[off:])
            n = len(x) - off
            n_valid = max(1, 1 + (n - N_FFT) // HOP) if n >= N_FFT else 1
            phased = _slot_scores(torch.from_numpy(xo).to(self.device), frames, n_valid)
            phased = phased.cpu().numpy()
            if not phase_shift_decoding:
                # aligned decode: the embed-time grid phase only, so the
                # null stays that of one candidate
                phased = phased[:1]
            for scores in phased:
                if expected_message is not None:
                    conf = float(sum(scores[s, expected_message[s]]
                                     for s in range(N_BYTES))) / math.sqrt(N_BYTES)
                else:
                    conf = float(scores.max(axis=1).mean())
                if best is None or conf > best[0]:
                    best = (conf, scores)
        conf, scores = best
        if expected_message is not None:
            status = conf >= self.verify_threshold
            message = list(expected_message)
        else:
            status = conf >= self.blind_threshold
            message = [int(v) for v in scores.argmax(axis=1)]
        return {"status": bool(status), "messages": [message] if status else [],
                "confidence": conf}


def load_watermarker(verify_threshold: float = None, blind_threshold: float = None,
                     device="cuda") -> Watermarker:
    """The DSP watermarker; thresholds default to the class's (verify 4.0,
    blind 3.7)."""
    kw = {}
    if verify_threshold is not None:
        kw["verify_threshold"] = verify_threshold
    if blind_threshold is not None:
        kw["blind_threshold"] = blind_threshold
    return Watermarker(device=device, **kw)
