"""Text tokenization, host side (port of ``sesameai_tts_tpu/tokenizer/text.py``).

Every tokenizer returns ids already wrapped in BOS…EOS:

* ``ByteTokenizer`` and ``TinyHashTokenizer`` for tests and tiny flavors;
* the Llama-3 tokenizer from a LOCAL ``tokenizer.json`` (``_load_bpe``):
  the native C++ BPE (``tokenizer/native_bpe.py``) with the exact
  pretokenizer, else ``HFTokenizer`` over the Rust ``tokenizers``
  package, else the native BPE with an ASCII-approximate pretokenizer and
  a warning.
"""

from __future__ import annotations

import os
import warnings
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


class HFTokenizer:
    """A local HF tokenizer.json through the Rust ``tokenizers`` package,
    with the BOS…EOS wrap applied explicitly."""

    def __init__(self, path: str, bos_token: str = "<|begin_of_text|>",
                 eos_token: str = "<|end_of_text|>"):
        from tokenizers import Tokenizer

        tok_file = os.path.join(path, "tokenizer.json") if os.path.isdir(path) else path
        self._tok = Tokenizer.from_file(tok_file)
        self.bos_id = self._tok.token_to_id(bos_token)
        self.eos_id = self._tok.token_to_id(eos_token)
        if self.bos_id is None or self.eos_id is None:
            raise ValueError(f"tokenizer at {path} lacks {bos_token}/{eos_token} specials")
        self.vocab_size = self._tok.get_vocab_size()

    def encode(self, text: str) -> List[int]:
        return [self.bos_id] + self._tok.encode(text, add_special_tokens=False).ids + [self.eos_id]

    def decode(self, ids: List[int]) -> str:
        return self._tok.decode(ids, skip_special_tokens=True)


def _load_bpe(path: str) -> TextTokenizer:
    """Exact-first resolution for a real tokenizer.json:

    1. native C++ BPE with the exact Llama-3 pretokenizer (needs ``regex``);
    2. ``HFTokenizer`` (always exact; needs ``tokenizers``);
    3. native BPE with the ASCII-approximate ``re`` pretokenizer, last and
       with a warning naming why 1 and 2 failed (it diverges on non-ASCII
       text).
    """
    from sesameai_tts_tpu_torch.tokenizer.native_bpe import NativeBPETokenizer

    errors = []
    try:
        return NativeBPETokenizer(path)
    except Exception as e:  # any failure moves on to the next backend
        errors.append(f"native BPE: {e!r}")
    try:
        return HFTokenizer(path)
    except Exception as e:
        errors.append(f"HF tokenizers: {e!r}")
        warnings.warn(
            "exact tokenizer backends failed (" + "; ".join(errors) + "): falling back to "
            "an ASCII-approximate pretokenizer (tokenization diverges from Llama-3 on "
            "non-ASCII text)",
            stacklevel=3,
        )
        return NativeBPETokenizer(path, require_exact_pretokenizer=False)


def load_llama3_tokenizer(path: str) -> TextTokenizer:
    """The Llama-3.2 tokenizer with BOS…EOS wrapping, from a LOCAL
    tokenizer.json or model directory."""
    return _load_bpe(path)


def load_text_tokenizer(spec: str) -> TextTokenizer:
    """spec: 'byte', 'tiny', a tokenizer.json path, or a model dir."""
    if spec == "byte":
        return ByteTokenizer()
    if spec == "tiny":
        return TinyHashTokenizer()
    return _load_bpe(spec)

