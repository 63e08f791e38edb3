"""Text tokenization, host side (port of ``sesameai_tts_tpu/tokenizer/text.py``).

Every tokenizer returns ids already wrapped in BOS…EOS.  The byte and
tiny-hash tokenizers are here; the Llama-3 BPE loaders are not ported yet.
"""

from __future__ import annotations

import zlib
from typing import List, Protocol


class TextTokenizer(Protocol):
    bos_id: int
    eos_id: int
    vocab_size: int

    def encode(self, text: str) -> List[int]:  # BOS…EOS wrapped
        ...

    def decode(self, ids: List[int]) -> str:
        ...


class ByteTokenizer:
    """UTF-8 bytes + BOS/EOS specials; ids fit any vocab ≥ 258."""

    def __init__(self, vocab_size: int = 512):
        self.vocab_size = vocab_size
        self.bos_id = 256
        self.eos_id = 257

    def encode(self, text: str) -> List[int]:
        return [self.bos_id] + list(text.encode("utf-8")) + [self.eos_id]

    def decode(self, ids: List[int]) -> str:
        return bytes(i for i in ids if i < 256).decode("utf-8", errors="replace")


class TinyHashTokenizer:
    """Deterministic word-hash tokenizer bounded by a tiny vocab, so test
    flavors (text_vocab_size 128) run the whole pipeline."""

    def __init__(self, vocab_size: int = 128):
        self.vocab_size = vocab_size
        self.bos_id = 0
        self.eos_id = 1

    def encode(self, text: str) -> List[int]:
        ids = [2 + (zlib.crc32(w.encode("utf-8")) % (self.vocab_size - 2)) for w in text.split()]
        return [self.bos_id] + ids + [self.eos_id]

    def decode(self, ids: List[int]) -> str:
        return " ".join(f"<{i}>" for i in ids)


def load_text_tokenizer(spec: str) -> TextTokenizer:
    """spec: 'byte' or 'tiny'."""
    if spec == "byte":
        return ByteTokenizer()
    if spec == "tiny":
        return TinyHashTokenizer()
    raise ValueError(f"tokenizer {spec!r} is not ported yet: use 'byte' or 'tiny'")
