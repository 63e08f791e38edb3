"""A prompt's frame rows, as CSM reads them: each text token a row with
the token in column K and only that column on; each audio frame a row
with its codes in columns 0..K-1 and those columns on; a turn of speaker
s is the text ``f"[{s}]{text}"`` wrapped in BOS...EOS.

The text tokenizers a configuration may name: ``byte`` (UTF-8 bytes,
BOS 256, EOS 257) and ``tiny`` (a word's CRC-32 modulo the vocabulary
less 2, plus 2; BOS 0, EOS 1; the tiny test flavor's).  Imports nothing
of the program under test.
"""

from __future__ import annotations

import zlib
from typing import List, Tuple

import numpy as np


def text_ids(tokenizer: str, text: str, vocab: int) -> List[int]:
    if tokenizer == "byte":
        return [256] + list(text.encode("utf-8")) + [257]
    if tokenizer == "tiny":
        return [0] + [2 + zlib.crc32(w.encode("utf-8")) % (vocab - 2) for w in text.split()] + [1]
    raise ValueError(f"no plain tokenizer {tokenizer!r}")


def text_rows(tokenizer: str, text: str, speaker: int, K: int,
              vocab: int) -> Tuple[np.ndarray, np.ndarray]:
    ids = text_ids(tokenizer, f"[{speaker}]{text}", vocab)
    tokens = np.zeros((len(ids), K + 1), np.int64)
    mask = np.zeros((len(ids), K + 1), bool)
    tokens[:, K] = ids
    mask[:, K] = True
    return tokens, mask


def audio_rows(codes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(F, K) codes → their rows, then the all-zero frame that ends a turn."""
    F_, K = codes.shape
    tokens = np.zeros((F_ + 1, K + 1), np.int64)
    mask = np.zeros((F_ + 1, K + 1), bool)
    tokens[:F_, :K] = codes
    mask[:, :K] = True
    return tokens, mask
