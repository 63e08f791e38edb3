"""The client's side of a request: what it asked for, when it was due and
sent, and when each PCM chunk reached it.

A request's ``Session`` gets a ``ChunkLog`` as its chunk queue: the pool
hands each chunk to it as it would to a listener, and the log stamps the
moment (``time.perf_counter``) and keeps the PCM.  The end of a session
(``None``) calls the loop back, so a closed loop sends its next request.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

import numpy as np


@dataclass
class Request:
    """One request of a traffic plan and, once sent, what came back."""

    text: str
    voice: int
    budget_ms: float
    temperature: float
    topk: int
    scheduled: float = 0.0  # perf_counter time it was due (open loop), or sent
    client: int = 0
    priority: Optional[int] = None  # admission class; None: the server derives it
    sent: Optional[float] = None
    chunk_log: List[Tuple[float, int]] = field(default_factory=list)  # (time, samples)
    pcm: List[np.ndarray] = field(default_factory=list)
    ended: Optional[float] = None
    session: object = None
    error: Optional[BaseException] = None
    cancelled: bool = False  # cut at the window's close (a closed loop)

    @property
    def greedy(self) -> bool:
        return self.topk <= 1

    def first_chunk_at(self) -> Optional[float]:
        return self.chunk_log[0][0] if self.chunk_log else None

    def frames(self, K: int) -> np.ndarray:
        """The frames served to this request, (F, K) int64."""
        s = self.session
        if s is None or not s.frames_out:
            return np.zeros((0, K), np.int64)
        return np.concatenate(s.frames_out).astype(np.int64)

    def audio(self) -> np.ndarray:
        return np.concatenate(self.pcm) if self.pcm else np.zeros((0,), np.float32)


class ChunkLog(queue.Queue):
    """A session's chunk queue that stamps each chunk as it arrives."""

    def __init__(self, request: Request, on_end: Callable[[Request], None]):
        super().__init__()
        self._request = request
        self._on_end = on_end

    def put(self, item, block=True, timeout=None):
        now = time.perf_counter()
        r = self._request
        if item is None:
            r.ended = now
            if r.session is not None and r.session.error is not None:
                r.error = r.session.error
            self._on_end(r)
        else:
            r.chunk_log.append((now, int(item.shape[0])))
            r.pcm.append(item)
        super().put(item, block, timeout)


class Sender:
    """Sends requests into a started ``BatchedTTSServer`` and keeps them."""

    def __init__(self, server, voices: list, on_end: Callable[[Request], None] = lambda r: None):
        self.server = server
        self.voices = voices
        self.on_end = on_end
        self.sent: List[Request] = []
        self.lock = threading.Lock()

    def send(self, r: Request) -> Request:
        v = self.voices[r.voice]
        r.sent = time.perf_counter()
        with self.lock:
            self.sent.append(r)
        try:
            r.session = self.server.submit(
                r.text, speaker=v.speaker, cached_context=v.handle,
                max_audio_length_ms=r.budget_ms, temperature=r.temperature, topk=r.topk,
                priority=r.priority, chunks=ChunkLog(r, self.on_end))
        except Exception as e:  # a refused request misses every limit
            r.error = e
            r.ended = time.perf_counter()
        return r
