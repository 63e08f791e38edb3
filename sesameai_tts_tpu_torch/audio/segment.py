"""AudioClip: host-side segment operations in place of pydub's
AudioSegment (port of ``sesameai_tts_tpu/audio/segment.py``): silence
padding, fades, concatenation, normalization, int16 conversion, export,
duration and a chunked ``speedup``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from sesameai_tts_tpu_torch.audio.io import write_wav


@dataclass
class AudioClip:
    samples: np.ndarray  # (T,) float32 in [-1, 1]
    sample_rate: int

    # -- constructors -------------------------------------------------------

    @classmethod
    def silent(cls, duration_ms: float, sample_rate: int) -> "AudioClip":
        n = int(round(duration_ms / 1000.0 * sample_rate))
        return cls(np.zeros(n, np.float32), sample_rate)

    @classmethod
    def from_float(cls, samples: np.ndarray, sample_rate: int) -> "AudioClip":
        return cls(np.asarray(samples, np.float32).reshape(-1), sample_rate)

    # -- properties ---------------------------------------------------------

    @property
    def duration_seconds(self) -> float:
        return len(self.samples) / self.sample_rate

    def __len__(self) -> int:  # milliseconds, like pydub
        return int(round(1000.0 * len(self.samples) / self.sample_rate))

    # -- ops (all functional, return new clips) -----------------------------

    def __add__(self, other: "AudioClip") -> "AudioClip":
        assert self.sample_rate == other.sample_rate
        return AudioClip(
            np.concatenate([self.samples, other.samples]), self.sample_rate
        )

    @classmethod
    def concat(cls, clips: "list[AudioClip]") -> "AudioClip":
        """Concatenate many clips in one allocation (a pairwise ``+``
        re-copies the growing buffer for every clip)."""
        assert clips, "concat of zero clips"
        sr = clips[0].sample_rate
        assert all(c.sample_rate == sr for c in clips)
        return cls(np.concatenate([c.samples for c in clips]), sr)

    def normalize(self, peak: float = 1.0) -> "AudioClip":
        m = max(float(np.abs(self.samples).max(initial=0.0)), 1e-6)
        return AudioClip(self.samples / m * peak, self.sample_rate)

    def fade_in(self, duration_ms: float) -> "AudioClip":
        n = min(int(duration_ms / 1000.0 * self.sample_rate), len(self.samples))
        out = self.samples.copy()
        if n > 0:
            out[:n] *= np.linspace(0.0, 1.0, n, dtype=np.float32)
        return AudioClip(out, self.sample_rate)

    def fade_out(self, duration_ms: float) -> "AudioClip":
        n = min(int(duration_ms / 1000.0 * self.sample_rate), len(self.samples))
        out = self.samples.copy()
        if n > 0:
            out[-n:] *= np.linspace(1.0, 0.0, n, dtype=np.float32)
        return AudioClip(out, self.sample_rate)

    def pad(self, start_ms: float = 0.0, end_ms: float = 0.0) -> "AudioClip":
        return (
            AudioClip.silent(start_ms, self.sample_rate)
            + self
            + AudioClip.silent(end_ms, self.sample_rate)
        )

    def speedup(
        self, playback_speed: float = 1.2, chunk_ms: int = 150, crossfade_ms: int = 25
    ) -> "AudioClip":
        """Pitch-preserving speed change by dropping a piece of every
        period, with crossfades (pydub's ``speedup`` algorithm)."""
        if playback_speed <= 1.0:
            return self
        sr = self.sample_rate
        chunk = int(chunk_ms / 1000.0 * sr)
        xfade = min(int(crossfade_ms / 1000.0 * sr), chunk // 2)
        # drop `drop` samples out of every `chunk + drop`
        drop = int(chunk * (playback_speed - 1.0))
        if drop == 0 or len(self.samples) < chunk + drop:
            return self
        period = chunk + drop
        pieces = []
        i = 0
        x = self.samples
        while i + period <= len(x):
            keep = x[i : i + chunk].copy()
            nxt = x[i + chunk : i + period]
            if xfade > 0 and len(nxt) >= xfade:
                ramp = np.linspace(1.0, 0.0, xfade, dtype=np.float32)
                keep[-xfade:] = keep[-xfade:] * ramp + nxt[:xfade] * (1.0 - ramp)
            pieces.append(keep)
            i += period
        pieces.append(x[i:])
        return AudioClip(np.concatenate(pieces), sr)

    # -- conversions --------------------------------------------------------

    def to_int16(self) -> np.ndarray:
        return (np.clip(self.samples, -1.0, 1.0) * 32767.0).astype(np.int16)

    def to_gradio(self) -> tuple:
        """(sample_rate, float32 ndarray), the web apps' audio format."""
        return (self.sample_rate, self.samples.astype(np.float32))

    def export(self, path: str) -> None:
        write_wav(path, self.samples, self.sample_rate)
