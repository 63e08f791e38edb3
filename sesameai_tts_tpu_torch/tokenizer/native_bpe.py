"""Native (C++) byte-level BPE tokenizer (port of
``sesameai_tts_tpu/tokenizer/native_bpe.py``).

Parses a local HF ``tokenizer.json`` (byte-level BPE, Llama-3 family) in
Python, loads vocab and merges into the C++ engine (``native/bpe.cpp`` at
the repository root, built by ``native/build.py`` with ``g++`` at first
use) through ctypes, pretokenizes with the Llama-3 pattern (the ``regex``
module when available, else a close ``re`` approximation), and encodes
each pretoken natively.  Ids come back wrapped in BOS…EOS like every
tokenizer of the port.
"""

from __future__ import annotations

import ctypes
import json
import os
from functools import lru_cache
from typing import Dict, List

# GPT-2 byte↔unicode table (the printable remapping byte-level BPE uses)


@lru_cache(maxsize=1)
def _byte_decoder() -> Dict[str, int]:
    bs = list(range(ord("!"), ord("~") + 1)) + list(
        range(ord("¡"), ord("¬") + 1)
    ) + list(range(ord("®"), ord("ÿ") + 1))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {chr(c): b for b, c in zip(bs, cs)}


def _token_to_bytes(token: str) -> bytes:
    dec = _byte_decoder()
    return bytes(dec[ch] for ch in token)


@lru_cache(maxsize=1)
def _load_lib():
    import sys

    native_dir = os.path.abspath(
        os.path.join(os.path.dirname(__file__), "..", "..")
    )
    if native_dir not in sys.path:
        sys.path.insert(0, native_dir)
    from native.build import build  # repo-root native/, outside both packages

    lib = ctypes.CDLL(build("bpe"))
    lib.bpe_new.restype = ctypes.c_void_p
    lib.bpe_new.argtypes = []
    lib.bpe_free.restype = None
    lib.bpe_free.argtypes = [ctypes.c_void_p]
    lib.bpe_add_token.restype = None
    lib.bpe_add_token.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
                                  ctypes.c_uint32]
    lib.bpe_add_merge.restype = None
    lib.bpe_add_merge.argtypes = [ctypes.c_void_p] + [ctypes.c_uint32] * 4
    lib.bpe_finalize.restype = ctypes.c_int
    lib.bpe_finalize.argtypes = [ctypes.c_void_p]
    lib.bpe_encode.restype = ctypes.c_int
    lib.bpe_encode.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint32),
        ctypes.c_int,
    ]
    return lib


# llama-3 pretokenizer pattern; needs the `regex` module for \p classes,
# with an `re` fallback that is close for ASCII-ish text
_LLAMA3_PATTERN = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?+\p{L}+|\p{N}{1,3}|"
    r" ?[^\s\p{L}\p{N}]++[\r\n]*|\s*[\r\n]|\s+(?!\S)|\s+"
)
_FALLBACK_PATTERN = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\w]?[A-Za-z]+|[0-9]{1,3}|"
    r" ?[^\sA-Za-z0-9]+[\r\n]*|\s*[\r\n]|\s+(?!\S)|\s+"
)


def has_exact_pretokenizer() -> bool:
    """True when the ``regex`` module (needed for the \\p classes in the
    llama-3 pretokenizer pattern) is importable."""
    try:
        import regex  # noqa: F401

        return True
    except ImportError:
        return False


@lru_cache(maxsize=1)
def _pretokenizer():
    try:
        import regex

        return regex.compile(_LLAMA3_PATTERN)
    except ImportError:
        import re

        return re.compile(_FALLBACK_PATTERN)


class NativeBPETokenizer:
    def __init__(self, path: str, bos_token: str = "<|begin_of_text|>",
                 eos_token: str = "<|end_of_text|>",
                 require_exact_pretokenizer: bool = True):
        # the `re` fallback pattern diverges from llama-3 pretokenization
        # on non-ASCII text; callers that have an exact alternative
        # (tokenizer/text.py prefers the Rust HFTokenizer then) must not
        # get a silently-approximate encoder
        if require_exact_pretokenizer and not has_exact_pretokenizer():
            raise ImportError(
                "the `regex` module is unavailable; NativeBPETokenizer would "
                "fall back to an ASCII-approximate pretokenizer. Pass "
                "require_exact_pretokenizer=False to accept the divergence."
            )
        tok_file = path
        if os.path.isdir(path):
            tok_file = os.path.join(path, "tokenizer.json")
        with open(tok_file) as f:
            spec = json.load(f)
        model = spec["model"]
        if model.get("type") != "BPE":
            raise ValueError("native tokenizer supports byte-level BPE only")

        self._lib = _load_lib()
        self._h = self._lib.bpe_new()

        vocab: Dict[str, int] = model["vocab"]
        self._id_to_token = {}
        for token, idx in vocab.items():
            raw = _token_to_bytes(token)
            self._id_to_token[idx] = raw
            self._lib.bpe_add_token(
                ctypes.c_void_p(self._h), raw, len(raw), ctypes.c_uint32(idx)
            )
        for rank, merge in enumerate(model["merges"]):
            if isinstance(merge, str):
                left, right = merge.split(" ", 1)
            else:
                left, right = merge
            li, ri = vocab.get(left), vocab.get(right)
            mi = vocab.get(left + right)
            if li is None or ri is None or mi is None:
                continue
            self._lib.bpe_add_merge(
                ctypes.c_void_p(self._h),
                ctypes.c_uint32(li), ctypes.c_uint32(ri),
                ctypes.c_uint32(mi), ctypes.c_uint32(rank),
            )
        self._lib.bpe_finalize(ctypes.c_void_p(self._h))

        specials = {t["content"]: t["id"] for t in spec.get("added_tokens", [])}
        self.bos_id = specials.get(bos_token, vocab.get(bos_token))
        self.eos_id = specials.get(eos_token, vocab.get(eos_token))
        if self.bos_id is None or self.eos_id is None:
            raise ValueError(f"missing {bos_token}/{eos_token} in {tok_file}")
        # total id space INCLUDING added tokens, matching the HF path's
        # get_vocab_size() — base-vocab-only left bos/eos >= vocab_size,
        # and consumers size embedding tables / validate ids against this
        self.vocab_size = max(
            len(vocab), *(i + 1 for i in specials.values())
        ) if specials else len(vocab)

    def __del__(self, _c_void_p=ctypes.c_void_p):
        # release the C++ vocab/merge maps (tens of MB). ctypes is bound
        # as a default arg: at interpreter shutdown module globals may
        # already be None'd, which made this raise (harmlessly but
        # noisily) in __del__
        lib, h = getattr(self, "_lib", None), getattr(self, "_h", None)
        if lib is not None and h:
            try:
                lib.bpe_free(_c_void_p(h))
            except TypeError:  # shutdown teardown already tore down ctypes
                pass
            self._h = None

    def encode(self, text: str) -> List[int]:
        ids = [self.bos_id]
        cap = 4096
        buf = (ctypes.c_uint32 * cap)()
        for m in _pretokenizer().finditer(text):
            piece = m.group(0).encode("utf-8")
            while True:
                n = self._lib.bpe_encode(
                    ctypes.c_void_p(self._h), piece, len(piece), buf, cap
                )
                if n != -2:
                    break
                cap *= 2  # output larger than the buffer: grow and retry
                buf = (ctypes.c_uint32 * cap)()
            if n < 0:
                raise ValueError(f"cannot encode piece {piece!r}")
            ids.extend(buf[i] for i in range(n))
        ids.append(self.eos_id)
        return ids

    def decode(self, ids: List[int]) -> str:
        out = b"".join(
            self._id_to_token.get(i, b"") for i in ids
            if i not in (self.bos_id, self.eos_id)
        )
        return out.decode("utf-8", errors="replace")
