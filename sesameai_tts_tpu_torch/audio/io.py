"""WAV read/write with the standard library and numpy (port of
``sesameai_tts_tpu/audio/io.py``).

``read_wav`` takes 8/16/24/32-bit integer PCM and 32/64-bit float WAVs
(plain or WAVE_FORMAT_EXTENSIBLE); ``read_wav_mono`` averages the
channels and resamples; ``write_wav`` writes 16-bit PCM.
"""

from __future__ import annotations

import struct
import wave
from typing import Tuple

import numpy as np


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """→ ((channels, T) float32 in [-1, 1], sample_rate)."""
    with open(path, "rb") as f:
        header = f.read(12)
        if header[:4] != b"RIFF" or header[8:12] != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        fmt = None
        data = None
        while True:
            chunk = f.read(8)
            if len(chunk) < 8:
                break
            cid, size = struct.unpack("<4sI", chunk)
            payload = f.read(size + (size & 1))
            if cid == b"fmt ":
                fmt = struct.unpack("<HHIIHH", payload[:16])
                fmt_payload = payload  # extensible: SubFormat GUID lives here
            elif cid == b"data":
                data = payload[:size]
        if fmt is None or data is None:
            raise ValueError(f"{path}: missing fmt/data chunk")
        audio_format, channels, rate, _, _, bits = fmt
        if audio_format == 0xFFFE:
            # WAVE_FORMAT_EXTENSIBLE: the REAL format is the SubFormat
            # GUID's first two bytes (offset 24 in the fmt payload).
            # Assuming integer PCM decoded float32 extensible WAVs (a
            # common DAW/sox export) as int garbage with no error.
            if len(fmt_payload) >= 26:
                audio_format = struct.unpack("<H", fmt_payload[24:26])[0]
            else:
                audio_format = 1  # short extensible header: assume PCM
        if audio_format == 3:  # IEEE float
            if bits == 32:
                x = np.frombuffer(data, "<f4").astype(np.float32)
            elif bits == 64:
                x = np.frombuffer(data, "<f8").astype(np.float32)
            else:
                raise ValueError(f"{path}: unsupported float bit depth {bits}")
        elif audio_format == 1:  # integer PCM
            if bits == 16:
                x = np.frombuffer(data, "<i2").astype(np.float32) / 32768.0
            elif bits == 32:
                x = np.frombuffer(data, "<i4").astype(np.float32) / 2147483648.0
            elif bits == 24:
                raw = np.frombuffer(data, np.uint8).reshape(-1, 3)
                ints = (
                    raw[:, 0].astype(np.int32)
                    | (raw[:, 1].astype(np.int32) << 8)
                    | (raw[:, 2].astype(np.int32) << 16)
                )
                ints = np.where(ints >= 1 << 23, ints - (1 << 24), ints)
                x = ints.astype(np.float32) / float(1 << 23)
            elif bits == 8:
                x = (np.frombuffer(data, np.uint8).astype(np.float32) - 128.0) / 128.0
            else:
                raise ValueError(f"{path}: unsupported PCM bit depth {bits}")
        else:
            raise ValueError(f"{path}: unsupported WAV format {audio_format}")
    return x.reshape(-1, channels).T.copy(), rate


def read_wav_mono(path: str, target_rate: int | None = None) -> Tuple[np.ndarray, int]:
    """Load → mono-ize → optional resample (the reference's _load_audio
    pipeline, tts_service.py:141-168)."""
    x, rate = read_wav(path)
    mono = x.mean(axis=0) if x.shape[0] > 1 else x[0]
    if target_rate is not None and rate != target_rate:
        from sesameai_tts_tpu_torch.audio.resample import resample

        mono = resample(mono, rate, target_rate)
        rate = target_rate
    return mono.astype(np.float32), rate


def write_wav(path: str, audio: np.ndarray, sample_rate: int) -> None:
    """(T,) or (C, T) float in [-1, 1] → 16-bit PCM WAV."""
    if audio.ndim == 1:
        audio = audio[None]
    pcm = np.clip(np.asarray(audio, np.float32), -1.0, 1.0)
    pcm16 = np.round(pcm * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(pcm16.shape[0])
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm16.T.tobytes())


def streaming_wav_header(sample_rate: int, channels: int = 1,
                         bits: int = 16) -> bytes:
    """44-byte PCM WAV header with unknown-length RIFF/data sizes.

    For chunked/streamed responses where the total length is unknown at
    header time: both size fields are 0xFFFFFFFF (the de-facto
    streaming-WAV convention — decoders, ``read_wav`` above included,
    read the data chunk to EOF), for streamed s16le responses.
    """
    block = channels * bits // 8
    return b"".join([
        b"RIFF", struct.pack("<I", 0xFFFFFFFF), b"WAVE",
        b"fmt ", struct.pack("<IHHIIHH", 16, 1, channels, sample_rate,
                             sample_rate * block, block, bits),
        b"data", struct.pack("<I", 0xFFFFFFFF),
    ])
