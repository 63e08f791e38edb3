"""Rolling conversation context (port of
``sesameai_tts_tpu/runtime/context.py``).

A pinned voice prefix (pre-tokenized once, its KV prefix precomputable)
plus a sliding window of dialog segments, evicted oldest first so that
prefix + window + the new utterance's text + its generation budget always
fit the backbone's positions.  ``pairs()`` feeds ``Generator.generate``
or ``precompute_context_state``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

TokenPair = Tuple[np.ndarray, np.ndarray]  # (tokens, mask), each (S, K+1)


def _rows(pair: TokenPair) -> int:
    return pair[0].shape[0]


@dataclass
class RollingContext:
    """Pinned prefix + sliding dialog window under a position budget."""

    max_positions: int = 2048
    generation_budget: int = 1125  # 90 s at 12.5 Hz (reference default max)
    text_budget: int = 128  # reserve for the new utterance's text rows
    max_segments: Optional[int] = None  # optional last-N cap (ogwebapp.py:109 used 7)

    _prefix: List[TokenPair] = field(default_factory=list)
    _window: List[TokenPair] = field(default_factory=list)

    def __post_init__(self):
        # keep defaults sane for small (test) position spaces
        self.generation_budget = min(self.generation_budget, self.max_positions // 2)
        self.text_budget = min(self.text_budget, self.max_positions // 8)

    # -- prefix (voice prompt) ---------------------------------------------

    def pin_prefix(self, pairs: Sequence[TokenPair]) -> None:
        rows = sum(_rows(p) for p in pairs)
        if rows > self.budget:
            raise ValueError(
                f"Pinned voice prefix ({rows} rows) alone exceeds the "
                f"context budget ({self.budget}); shorten the voice prompt"
            )
        self._prefix = list(pairs)

    @property
    def prefix_rows(self) -> int:
        return sum(_rows(p) for p in self._prefix)

    # -- dialog window ------------------------------------------------------

    def append(self, pair: TokenPair, oversize: str = "raise") -> None:
        """Add a finished dialog segment (user or assistant turn).

        A segment that alone exceeds the budget either raises
        (``oversize='raise'``, the default — eviction would silently pop
        the JUST-APPENDED turn while the caller believes it was
        recorded; pin_prefix raises for the analogous case) or keeps its
        TAIL rows (``oversize='trim'`` — live loops like the duplex app
        must degrade, not crash mid-conversation; the most recent audio
        carries the prosody the next turn continues from)."""
        room = self.budget - self.prefix_rows
        if _rows(pair) > room:
            if oversize != "trim":
                raise ValueError(
                    f"segment ({_rows(pair)} rows) cannot fit the context "
                    f"budget ({self.budget} minus {self.prefix_rows} "
                    f"pinned); split it, raise max_positions, or pass "
                    f"oversize='trim'"
                )
            t, m = pair
            pair = (t[-max(room, 0):], m[-max(room, 0):])
            if _rows(pair) == 0:
                return  # no room at all: nothing recordable
        self._window.append(pair)
        self._evict()

    @property
    def window_rows(self) -> int:
        return sum(_rows(p) for p in self._window)

    @property
    def budget(self) -> int:
        return self.max_positions - self.generation_budget - self.text_budget

    def _evict(self) -> None:
        if self.max_segments is not None:
            while len(self._window) > self.max_segments:
                self._window.pop(0)
        while self._window and self.prefix_rows + self.window_rows > self.budget:
            self._window.pop(0)
        if self.prefix_rows > self.budget:
            raise ValueError(
                f"Pinned voice prefix ({self.prefix_rows} rows) alone exceeds the "
                f"context budget ({self.budget}); shorten the voice prompt"
            )

    def clear(self) -> None:
        self._window = []

    def pairs(self) -> List[TokenPair]:
        """Current full context (prefix + window) as pre-tokenized pairs —
        feed directly to Generator.generate(...)/precompute_context_state."""
        return self._prefix + self._window

    @property
    def total_rows(self) -> int:
        return self.prefix_rows + self.window_rows
