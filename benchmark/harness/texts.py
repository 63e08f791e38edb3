"""The inputs a traffic mix draws from its seed: texts from a word list,
sizes from a fixed set of quantiles in an order of the seed's, and the
cached voices.

Every seed gets the same set of sizes (text rows, audio budgets, gaps
between arrivals, voice lengths) in another order, so two seeds ask the
same work of the system and differ in its order and in the words.

A request's text is sized by the rows its prompt takes, not by words: a
mix gives the rows a Llama-3 tokenizer would make of its texts (about
1.3 a word, with the speaker tag and BOS/EOS), and the text is cut to
that many rows under the configuration's own tokenizer.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import List, Set, Tuple

import numpy as np

from benchmark.reference import tokens as ref_tokens

_WORDS = (Path(__file__).resolve().parents[1] / "traffic" / "words.txt").read_text().split()


def spread(lo: float, hi: float, n: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` values spread evenly over [lo, hi] (the midpoints of n equal
    slices), in the seed's order."""
    return rng.permutation(lo + (hi - lo) * (np.arange(n) + 0.5) / n)


def _join(words: List[str], n_sentences: int) -> str:
    """``words`` in ``n_sentences`` sentences of about equal length."""
    k = max(1, min(n_sentences, len(words)))
    out = []
    for part in np.array_split(np.array(words, dtype=object), k):
        s = " ".join(part)
        out.append(s[:1].upper() + s[1:] + ".")
    return " ".join(out)


def sized(config: dict, speaker: int, rows: int, n_sentences: int,
          rng: np.random.Generator) -> str:
    """A text in up to ``n_sentences`` sentences whose turn for ``speaker``
    takes ``rows`` text rows under the configuration's tokenizer, or up to
    two more where a sentence's break does not allow it: words from the
    word list while the rows fall short, then the last word cut short
    where the tokenizer reads characters."""
    K, vocab, tok = config["audio_num_codebooks"], config["text_vocab_size"], config["tokenizer"]

    def count(text: str) -> int:
        return ref_tokens.text_rows(tok, text, speaker, K, vocab)[0].shape[0]

    words = [str(rng.choice(_WORDS))]
    while count(_join(words, n_sentences)) < rows and len(words) < 4096:
        words.append(str(rng.choice(_WORDS)))
    while count(_join(words, n_sentences)) > rows and len(words[-1]) > 1:
        shorter = words[:-1] + [words[-1][:-1]]
        if count(_join(shorter, n_sentences)) < rows:
            break
        words = shorter
    return _join(words, n_sentences)


@dataclass
class Voice:
    """A cached voice: its prompt rows (the benchmark's, handed to the
    program and the reference alike), speaker id and the program's handle."""

    speaker: int
    tokens: np.ndarray  # (R, K+1)
    mask: np.ndarray
    handle: object = None


def make_voices(config: dict, n: int, rows: Tuple[int, int],
                rng: np.random.Generator) -> List[Voice]:
    """``n`` voice prompts of ``rows`` rows each (spread over the range): a
    transcript's text rows, then audio frames of codes drawn from the
    seed and the all-zero frame that ends the turn.  About half the rows
    are text."""
    K = config["audio_num_codebooks"]
    vocab = config["text_vocab_size"]
    tok = config["tokenizer"]
    bins = config["mimi"]["rvq"]["bins"]
    voices = []
    for speaker, total in enumerate(np.round(spread(rows[0], rows[1], n, rng)).astype(int)):
        text = ""
        while True:  # grow the transcript to about half the rows
            nxt = (text + " " + str(rng.choice(_WORDS))).strip()
            t, _ = ref_tokens.text_rows(tok, nxt, speaker, K, vocab)
            if t.shape[0] > total // 2 and text:
                break
            text = nxt
        t_tok, t_mask = ref_tokens.text_rows(tok, text, speaker, K, vocab)
        frames = max(1, int(total) - t_tok.shape[0] - 1)
        codes = rng.integers(0, bins, size=(frames, K))
        a_tok, a_mask = ref_tokens.audio_rows(codes)
        voices.append(Voice(speaker, np.concatenate([t_tok, a_tok]),
                            np.concatenate([t_mask, a_mask])))
    return voices


def prompt_rows(config: dict, voice: Voice, text: str) -> Tuple[np.ndarray, np.ndarray]:
    """The whole prompt of a request in ``voice``: the voice's rows, then
    the request's text rows."""
    t, m = ref_tokens.text_rows(config["tokenizer"], text, voice.speaker,
                                config["audio_num_codebooks"], config["text_vocab_size"])
    return np.concatenate([voice.tokens, t]), np.concatenate([voice.mask, m])


def text_rows(config: dict, voice: Voice, text: str) -> int:
    return ref_tokens.text_rows(config["tokenizer"], text, voice.speaker,
                                config["audio_num_codebooks"], config["text_vocab_size"])[0].shape[0]


def pick(n: int, share_every: int, rng: np.random.Generator) -> Set[int]:
    """Which of ``n`` requests are greedy: one in ``share_every``, at
    indices of the seed's."""
    return set(rng.permutation(n)[: n // share_every].tolist()) if share_every else set()
