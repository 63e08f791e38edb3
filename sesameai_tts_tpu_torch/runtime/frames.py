"""Segment → (K+1)-column frame tokenization, host side with numpy (port of
``sesameai_tts_tpu/runtime/frames.py``).

* a text token becomes a row with the token in column K and only column
  K masked;
* audio is Mimi-encoded to (K, F) codes, one all-zero EOS frame is
  appended, and each frame becomes a row with codes in columns 0..K-1;
* a Segment is its text rows followed by its audio rows;
* text prompts are encoded as ``f"[{speaker}]{text}"``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


@dataclass
class Segment:
    """A conversation turn: speaker id, transcript, 24 kHz mono audio."""

    speaker: int
    text: str
    audio: np.ndarray  # (num_samples,) float32 @ 24 kHz


def pad_audio_to_frame_bucket(audio: np.ndarray, hop: int) -> Tuple[np.ndarray, int]:
    """(T,) waveform → ((1, 1, bucket·hop) zero-padded wav, frame count),
    padded to whole codec frames and then to a power-of-2 frame bucket
    (the causal encoder makes right-padding exact)."""
    T = len(audio)
    frames = max(1, -(-T // hop))
    bucket = 1 << (frames - 1).bit_length()
    wav = np.zeros((1, 1, bucket * hop), np.float32)
    wav[0, 0, :T] = audio
    return wav, frames


def tokenize_text_segment(tokenizer, text: str, speaker: int,
                          num_codebooks: int) -> Tuple[np.ndarray, np.ndarray]:
    """→ ((S, K+1) int32 tokens, (S, K+1) bool mask)."""
    K = num_codebooks
    ids = tokenizer.encode(f"[{speaker}]{text}")
    tokens = np.zeros((len(ids), K + 1), np.int32)
    mask = np.zeros((len(ids), K + 1), bool)
    tokens[:, K] = ids
    mask[:, K] = True
    return tokens, mask


def tokenize_audio_codes(codes: np.ndarray, num_codebooks: int,
                         append_eos: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """(K, F) Mimi codes → ((F[+1], K+1) tokens, mask) with an EOS frame."""
    K = num_codebooks
    if codes.shape[0] != K:
        raise ValueError(f"expected {K} codebooks, got {codes.shape[0]}")
    if append_eos:
        codes = np.concatenate([codes, np.zeros((K, 1), codes.dtype)], axis=1)
    F = codes.shape[1]
    tokens = np.zeros((F, K + 1), np.int32)
    mask = np.zeros((F, K + 1), bool)
    tokens[:, :K] = codes.T
    mask[:, :K] = True
    return tokens, mask


class FrameTokenizer:
    """Binds a text tokenizer and a Mimi encoder into Segment tokenization."""

    def __init__(self, text_tokenizer, audio_encoder, num_codebooks: int):
        """audio_encoder: callable (num_samples,) float32 → (K, F) int codes."""
        self.text_tokenizer = text_tokenizer
        self.audio_encoder = audio_encoder
        self.num_codebooks = num_codebooks

    def text_segment(self, text: str, speaker: int):
        return tokenize_text_segment(self.text_tokenizer, text, speaker, self.num_codebooks)

    def audio_segment(self, audio: np.ndarray):
        if audio.ndim != 1:
            raise ValueError("Audio must be single channel")
        codes = np.asarray(self.audio_encoder(audio))
        return tokenize_audio_codes(codes, self.num_codebooks)

    def segment(self, segment: Segment):
        """→ ((S, K+1), (S, K+1)): text rows then audio rows."""
        tt, tm = self.text_segment(segment.text, segment.speaker)
        at, am = self.audio_segment(segment.audio)
        return np.concatenate([tt, at]), np.concatenate([tm, am])
