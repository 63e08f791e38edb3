"""Batched multi-session serving: continuous batching over a slot pool
(port of ``sesameai_tts_tpu/runtime/serving.py``).

B sessions decode in one batched step: the pool is the static decode state
at B = slots of a clone of the Generator (``_ticker``), whose CUDA graphs
keep their addresses, plus one batched streaming Mimi state.  Admissions
prefill at B=1 on a second clone (``_admitter``) into a state the server
owns; the tick thread copies it into a free slot (row copies into the
pool's static tensors).  Every tick replays the backbone and sampling
graphs n times at B = slots, then decodes the tick's codes through the
batched streaming Mimi decode; frames, flags and PCM are copied to pinned
host memory without blocking and read one tick later (lag 1), so the host
waits only for the tick before the one it just launched.

Threads: the dispatch thread prefills (``_dispatch_admission``), the
completion thread waits for an admission's first chunk and emits it
(``_complete_admission``), the tick thread attaches and decodes
(``_tick``).  On the card each clone's work runs on its own stream
(``Generator.own_stream``); the tick stream waits for an admission's event
before it copies that admission's state, and every graph serving can
replay is captured before the threads start (``start``).  The Generator
passed in is not used by the server, so its caller may go on generating.
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np
import torch

from sesameai_tts_tpu_torch.models import csm as csm_model
from sesameai_tts_tpu_torch.runtime.generator import FRAME_MS, Generator
from sesameai_tts_tpu_torch.utils.profiling import Metrics

log = logging.getLogger(__name__)


class ServerSaturated(RuntimeError):
    """Raised by a non-blocking submit when the admission backlog is full.

    The HTTP front end maps this to 429 + Retry-After; in-process callers
    either catch it or use the default blocking submit."""

    def __init__(self, msg: str, retry_after_s: float = 1.0):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


@dataclass
class Session:
    """One TTS request; audio chunks arrive on ``chunks`` (None = end).

    ``cached_context`` takes a Generator ``precompute_context_state``
    handle: the voice-prefix KV is copied instead of prefilled again."""

    text: str
    speaker: int = 1
    context: Sequence = ()
    temperature: float = 0.8
    topk: int = 40
    max_audio_length_ms: float = 30_000
    # admission class: lower admits first (FIFO within a class). None =
    # derived from max_audio_length_ms at submit (short requests are
    # interactive, long ones bulk), see BatchedTTSServer.submit
    priority: Optional[int] = None
    cached_context: Optional[tuple] = None
    chunks: "queue.Queue[Optional[np.ndarray]]" = field(default_factory=queue.Queue)
    frames_out: List[np.ndarray] = field(default_factory=list)
    error: Optional[Exception] = None
    cancelled: bool = False
    submitted_at: float = field(default_factory=time.time)
    first_audio_at: Optional[float] = None
    finished_at: Optional[float] = None

    def cancel(self) -> None:
        """Stop generating for this session: frees its slot at the next
        tick (chunks already queued stay readable)."""
        self.cancelled = True

    def audio(self, timeout: Optional[float] = None) -> np.ndarray:
        """Block until finished; return the concatenated PCM.

        ``timeout`` bounds the TOTAL wait (not each chunk gap): on expiry
        the chunks already queued still drain, then ``queue.Empty`` is
        raised if the session would have to be waited on further."""
        out = []
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if deadline is None:
                chunk = self.chunks.get()
            else:
                rem = deadline - time.monotonic()
                chunk = self.chunks.get(timeout=rem) if rem > 0 else self.chunks.get_nowait()
            if chunk is None:
                break
            out.append(chunk)
        if self.error is not None:
            raise self.error
        return np.concatenate(out) if out else np.zeros((0,), np.float32)


def _on(gen: Generator):
    """Run the block's device work on ``gen``'s own stream (nothing on the
    CPU)."""
    stream = gen.own_stream()
    return contextlib.nullcontext() if stream is None else torch.cuda.stream(stream)


class _Fetch:
    """Device tensors copied to pinned host memory without blocking, behind
    an event on the current stream; ``wait`` syncs on that event alone."""

    def __init__(self, tensors: Sequence[torch.Tensor]):
        self.event = None
        if tensors[0].device.type == "cpu":
            self._host = list(tensors)
            return
        self._host = []
        for t in tensors:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            self._host.append(h)
        self.event = torch.cuda.Event()
        self.event.record()

    def wait(self) -> List[np.ndarray]:
        if self.event is not None:
            self.event.synchronize()
        return [h.numpy() for h in self._host]


def _tensors(tree):
    """The tensors of a nested tuple / list / NamedTuple (None leaves skipped)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for t in tree:
            yield from _tensors(t)


def _copy_row(pool, one, slot: int, axis: int) -> None:
    """Row ``slot`` along ``axis`` of every tensor in ``pool`` ← row 0 of the
    matching tensor in ``one``, in place."""
    for dst, src in zip(_tensors(pool), _tensors(one)):
        dst.select(axis, slot).copy_(src.select(axis, 0))


class BatchedTTSServer:
    """Slot-pool scheduler over a Generator's model and codec.

    Sampling parameters are per slot: temperature and topk are rows of the
    pool's decode buffers, written at attach, so concurrent sessions keep
    their own.  The pool replays the greedy graph only when every live
    session is greedy; a topk=1 session in a sampled batch still takes its
    greedy frames (``ops/sampling.py``).

    Admission prefill runs on its own thread and stream: the tick thread
    only copies ready states into slots, so new sessions do not stall the
    decode in flight."""

    def __init__(self, generator: Generator, slots: int = 4, chunk_frames: int = 10,
                 max_pending: Optional[int] = None):
        self.gen = generator
        self.B = slots
        # the streaming Mimi decode carries a ring cache whose slack caps the
        # frames per tick (codec/transformer.py raises): clamp, not crash
        ring_cap = generator._mimi.max_stream_chunk_frames
        if chunk_frames > ring_cap:
            log.warning("chunk_frames=%d exceeds the codec streaming ring (%d frames/tick); "
                        "clamping", chunk_frames, ring_cap)
            chunk_frames = ring_cap
        self.chunk = chunk_frames
        # each device user gets a clone over the shared weights (its own static
        # state, graphs, RNG and stream): the tick thread, the admission thread
        # and link_canary (which must not touch the live pool)
        self._ticker = generator.clone(seed=1)
        self._admitter = generator.clone(seed=2)
        self._canary = generator.clone(seed=3)
        self._budget = np.zeros(slots, np.int64)  # frames left per slot
        self._sessions: List[Optional[Session]] = [None] * slots
        self._reset_pool_state()
        # admission backlog. ``max_pending`` bounds it (backpressure): a full
        # backlog makes non-blocking submits raise ServerSaturated (HTTP 429)
        # instead of queueing without bound.  None = unbounded.
        self.max_pending = max_pending
        # priority admission queue of (priority, seq, session): an interactive
        # request submitted behind a bulk burst admits first; seq keeps FIFO
        # within a class and orders entries without comparing Sessions
        self._pending: "queue.PriorityQueue[tuple]" = queue.PriorityQueue(maxsize=max_pending or 0)
        self._seq = itertools.count()
        # admissions in flight on the admission threads; the tick loop
        # shrinks its ticks while any wait, so a prefill does not queue
        # behind long ticks (TTFA under load)
        self._admitting = 0
        # prefilled sessions waiting for a slot.  Bounded: each pins a B=1
        # backbone KV cache (+ codec state) on the device
        self._ready: "queue.Queue[tuple]" = queue.Queue(maxsize=max(2, slots))
        # dispatched admissions whose first chunk has not been fetched yet
        # (dispatch → completion thread); bounded for the same reason
        self._dispatched: "queue.Queue[tuple]" = queue.Queue(maxsize=2)
        self._lock = threading.Lock()
        # submit(wait=True) callers park here; the dispatch loop notifies after
        # taking a _pending entry and stop() broadcasts
        self._backlog_cv = threading.Condition(self._lock)
        # parked submit(wait=True) callers: part of the real backlog though
        # invisible to _pending.qsize(), so _tick_size counts them
        self._parked = 0
        self._inflight = None  # the lag-1 tick waiting to be read
        self._running = False
        self.metrics = Metrics()
        self._sessions_total = 0
        self._frames_total = 0
        self._started_at = time.time()
        self._thread: Optional[threading.Thread] = None
        self._admitter_thread: Optional[threading.Thread] = None
        self._completer: Optional[threading.Thread] = None

    def _reset_pool_state(self) -> None:
        """(Re)set the pool: every slot idle (done), the static state zeroed,
        a new batched Mimi state.  At construction, after a capture (its
        warm-up call writes the state) and in the recovery from a failed
        tick."""
        t = self._ticker
        with _on(t):
            state, bufs = t._slot(self.B)
            csm_model.load_state(state)
            bufs.frame.zero_()
            bufs.done.fill_(True)
            # idle slots decode zero frames through Mimi too; attach resets them
            self._mimi_state = t._mimi.init_decode_state(self.B, t._mimi_dtype, t.device)

    def _capture_all(self) -> dict:
        """Capture every graph serving can replay, the ones that do not exist
        yet → {name: seconds}: the prefill's frame at B=1 (greedy and
        sampled) on the admission clone, the backbone step and a frame's
        sampling at B = slots (greedy and sampled) on the tick clone, and the
        sampled ones on the canary clone."""
        times = {}
        with self._admitter._request():
            for greedy in (False, True):
                times.update(self._admitter._capture(1, greedy, ("prefill_sample",)))
        pool = {}
        for greedy in (False, True):
            pool.update(self._ticker._capture(self.B, greedy, ("backbone", "sample")))
        with self._canary._request():
            times.update({f"canary_{k}": v for k, v in self._canary._capture(
                self.B, False, ("backbone", "sample")).items()})
        if pool:
            self._reset_pool_state()
        times.update(pool)
        return times

    # -- public API -----------------------------------------------------------

    def warmup(self) -> dict:
        """Do before traffic what a first request would otherwise pay for →
        {name: seconds}: capture the graphs (``_capture_all``), run the
        prefill at every bucket and the first chunk's Mimi decode on the
        admission clone, and the batched Mimi decode at B = slots for both
        tick sizes ({chunk, 3}) on throwaway codec states.  Safe on a
        running server (the graphs then exist, and nothing touches the
        pool)."""
        times = self._capture_all()
        a, t = self._admitter, self._ticker
        K = a._cfg.audio_num_codebooks
        with a._request(), _on(a):
            times.update(a._warm_prefill_buckets())
            t0 = time.perf_counter()
            pcm, _ = a._first_chunk(torch.zeros((1, K), dtype=torch.int64, device=a.device))
            pcm.cpu()
            times["first_chunk"] = time.perf_counter() - t0
        with _on(t):
            for n in sorted({self.chunk, 3}):
                t0 = time.perf_counter()
                codes = torch.zeros((self.B, K, n), dtype=torch.int64, device=t.device)
                wav, _ = t._mimi.decode_streaming(
                    t._mimi_params, codes, t._mimi.init_decode_state(self.B, t._mimi_dtype,
                                                                     t.device))
                wav.cpu()
                times[f"mimi_tick_b{self.B}_n{n}"] = time.perf_counter() - t0
        return times

    def link_canary(self, reps: int = 3) -> dict:
        """Drift canary: time the serving tick (``chunk`` frames at B = slots,
        sampled, then the batched Mimi decode) on the canary clone's own
        state, so operators can tell "code regressed" from "the card is
        slow" in one call.  Never touches the live pool, but shares the
        card: a deep health check under heavy traffic measures traffic too.
        (The JAX package's link round-trip probe has no counterpart on a
        local card.)  Exposed as GET /healthz?deep=1."""
        c = self._canary
        n, K = self.chunk, c._cfg.audio_num_codebooks
        with c._request(), _on(c):
            c._capture(self.B, False, ("backbone", "sample"))  # a no-op once warmed up
            state, bufs = c._slot(self.B)
            csm_model.load_state(state)
            bufs.frame.zero_()
            bufs.done.zero_()
            csm_model.set_sampling(bufs, 1.0, 5)
            ms = c._mimi.init_decode_state(self.B, c._mimi_dtype, c.device)
            # one warm tick, then timed ticks with a single trailing sync
            _, _, _, pcm, ms = c._serve_tick(self.B, n, 0, False, ms)
            pcm.cpu()
            t0 = time.perf_counter()
            for i in range(reps):
                _, _, _, pcm, ms = c._serve_tick(self.B, n, i + 1, False, ms)
            pcm.cpu()
            dt = time.perf_counter() - t0
            csm_model.load_state(state)
        return {
            "tick_ms_per_frame_step": round(dt / reps / n * 1e3, 3),
            "tick_frames_per_s": round(self.B * n * reps / dt, 1),
            "tick_batch": self.B,
            "tick_frames": n,
            "device": str(c.device),
        }

    # requests budgeted at or under this admit ahead of longer ones
    # (Session.priority overrides): interactive probes and short sentences
    INTERACTIVE_MAX_MS = 4_000

    def submit(self, text: str, wait: bool = True, **kw) -> Session:
        """Enqueue one request.  ``wait=False`` raises ServerSaturated instead
        of blocking when the bounded backlog (``max_pending``) is full: the
        HTTP front end's 429 path.

        Admission order is priority-then-FIFO: ``priority`` (lower first;
        when unset, requests budgeted ≤ ``INTERACTIVE_MAX_MS`` are class 0,
        longer ones class 1), so an interactive request never waits behind a
        bulk burst's admissions."""
        s = Session(text=text, **kw)
        prio = s.priority
        if prio is None:
            prio = 0 if s.max_audio_length_ms <= self.INTERACTIVE_MAX_MS else 1
        with self._backlog_cv:  # atomic with stop()'s _running flip: no session
            # may be enqueued after the final drain (its listener would block)
            while True:
                if not self._running:
                    raise RuntimeError("server is not running (call start())")
                try:
                    self._pending.put_nowait((prio, next(self._seq), s))
                    self._sessions_total += 1
                    return s
                except queue.Full:
                    if not wait:
                        raise ServerSaturated(
                            f"admission backlog full ({self.max_pending} queued, {self.B} slots)",
                            retry_after_s=self._retry_after_estimate(),
                        ) from None
                # park until the dispatch loop takes an entry or stop()
                # broadcasts; the timeout only backs up a missed wake-up
                self._parked += 1
                try:
                    self._backlog_cv.wait(timeout=0.5)
                finally:
                    self._parked -= 1

    def _retry_after_estimate(self) -> float:
        """Seconds until the backlog likely has room: queued work over the
        pool's session turnover (median session time per slot), clamped to
        [1, 30]."""
        sess = self.metrics.summary().get("session_s", {})
        per = float(sess.get("p50", 2.0)) or 2.0
        q = self._pending.qsize()
        return float(min(30.0, max(1.0, q * per / max(self.B, 1))))

    def synthesize_batch(self, texts: Sequence[str], timeout: Optional[float] = 600.0,
                         **kw) -> List[np.ndarray]:
        """Synthesize many utterances concurrently over the slot pool; return
        their PCM in input order.  ``kw`` (speaker, temperature, topk,
        cached_context, ...) applies to every text; ``timeout`` is one
        deadline for the whole batch.  A failed utterance raises after the
        others are collected."""
        sessions = [self.submit(t, **kw) for t in texts]
        deadline = None if timeout is None else time.monotonic() + timeout
        out: List[Optional[np.ndarray]] = [None] * len(sessions)
        first_err: Optional[Exception] = None
        for i, s in enumerate(sessions):
            rem = None if deadline is None else max(0.0, deadline - time.monotonic())
            try:
                out[i] = s.audio(timeout=rem)
            except Exception as e:  # keep draining: later sessions still hold slots
                first_err = first_err or e
                s.cancel()
        if first_err is not None:
            raise first_err
        return out  # type: ignore[return-value]

    def metrics_summary(self) -> dict:
        """TTFA percentiles, frame and session counters, occupancy: the
        /metrics HTTP surface."""
        occupied = sum(1 for s in self._sessions if s is not None)
        return {
            "sessions_total": self._sessions_total,
            "frames_total": self._frames_total,
            "slots": self.B,
            "slots_occupied": occupied,
            "uptime_s": round(time.time() - self._started_at, 3),
            "series": self.metrics.summary(),
        }

    def start(self):
        """Capture every graph serving can replay (no capture happens once the
        threads run), then start the dispatch, completion and tick threads."""
        self._capture_all()
        self._running = True
        self._admitter_thread = threading.Thread(target=self._dispatch_loop, daemon=True)
        self._admitter_thread.start()
        self._completer = threading.Thread(target=self._completion_loop, daemon=True)
        self._completer.start()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _terminate_queued(self, err: Exception) -> None:
        """Drain _pending, _dispatched and _ready, ending every queued
        session with ``err`` (stop() and a pool that cannot be rebuilt)."""
        for q in (self._pending, self._dispatched, self._ready):
            while True:
                try:
                    item = q.get_nowait()
                except queue.Empty:
                    break
                # _pending entries are (prio, seq, session); the others carry
                # the session first
                s = item if isinstance(item, Session) else next(
                    x for x in item if isinstance(x, Session))
                s.error = err
                s.chunks.put(None)

    def stop(self):
        with self._backlog_cv:  # after this, submit() raises: nothing can be
            self._running = False  # enqueued past the drain below
            self._backlog_cv.notify_all()  # parked submitters see the flip
        for t in (self._thread, self._admitter_thread, self._completer):
            if t:
                t.join(timeout=10)
        # sessions still queued or attached when the threads exit observe the
        # end: a listener blocked in audio() without a timeout would hang
        err = RuntimeError("server stopped")
        self._terminate_queued(err)
        for slot in range(self.B):
            s = self._sessions[slot]
            if s is not None:
                s.error = err
                self._sessions[slot] = None
                s.chunks.put(None)

    # -- admission (its own threads: prefill and the first chunk's fetch) -----

    def _add_admitting(self, n: int) -> None:
        with self._lock:
            self._admitting += n

    def _dispatch_admission(self, session: Session):
        """Stage 1: enqueue one session's prefill and first-chunk decode on the
        admission clone's stream, and their copies to the host (nothing
        waits here).  Returns the in-flight record, or None if the session
        failed."""
        a = self._admitter
        max_gen = int(session.max_audio_length_ms / FRAME_MS)
        try:
            with _on(a):
                frame, state1, done1, max_gen = a._prefill_admission(
                    session.text, session.speaker, list(session.context),
                    session.cached_context, max_gen, session.temperature, session.topk,
                    a._utterance_seed(None))
                pcm0, ms1 = a._first_chunk(frame)
                # (done, frame, PCM) in one fetch: an admission's only host sync;
                # its event also orders the pool's copy of state1 after the prefill
                fetch = _Fetch([done1, frame, pcm0])
        except Exception as e:
            session.error = e
            session.chunks.put(None)
            return None
        return (session, frame, state1, max_gen, ms1, fetch)

    def _complete_admission(self, inflight) -> None:
        """Stage 2: wait for the dispatched first chunk, emit first audio, hand
        the session to the tick thread (or finish it on EOS)."""
        session, frame, state1, max_gen, ms1, fetch = inflight
        try:
            done1_np, frame_np, wav0 = fetch.wait()
        except Exception as e:
            session.error = e
            session.chunks.put(None)
            return
        done1_np = bool(done1_np[0])
        # first audio leaves here, on the admission thread: TTFA does not wait
        # for the tick thread to find a free slot
        if not done1_np:
            self._emit_session(session, frame_np.astype(np.int32), wav0[0])
        if done1_np or max_gen <= 1:
            # EOS on the prefill's frame, or a one-frame budget: the session is
            # complete without ever occupying a slot
            self._finish_session(session)
            return
        item = (session, frame, state1, max_gen, ms1, fetch)
        placed = False
        while self._running:  # bounded queue: block without hanging stop()
            try:
                self._ready.put(item, timeout=0.2)
                placed = True
                break
            except queue.Full:
                continue
        if not placed:  # stop() raced the bounded put: end the session
            session.error = RuntimeError("server stopped")
            session.chunks.put(None)

    def _dispatch_loop(self):
        """Admission stage 1 (own thread): enqueue session N+1's prefill while
        session N's first chunk is fetched on the completion thread."""
        while self._running:
            try:
                _, _, session = self._pending.get(timeout=0.05)
            except queue.Empty:
                continue
            with self._backlog_cv:  # a backlog place just freed: wake one
                self._backlog_cv.notify()  # parked submit(wait=True)
            if session.cancelled:
                session.chunks.put(None)
                continue
            self._add_admitting(1)
            inflight = self._dispatch_admission(session)
            if inflight is None:
                self._add_admitting(-1)
                continue
            placed = False
            while self._running:  # bounded: at most 2 B=1 states beyond _ready
                try:
                    self._dispatched.put(inflight, timeout=0.2)
                    placed = True
                    break
                except queue.Full:
                    continue
            if not placed:  # stop() raced the bounded put
                session.error = RuntimeError("server stopped")
                session.chunks.put(None)
                self._add_admitting(-1)

    def _completion_loop(self):
        """Admission stage 2 (own thread): fetch dispatched first chunks in
        dispatch order and hand the sessions to the tick thread."""
        while self._running:
            try:
                inflight = self._dispatched.get(timeout=0.05)
            except queue.Empty:
                continue
            self._complete_admission(inflight)
            self._add_admitting(-1)

    # -- the pool (the tick thread) ---------------------------------------------

    def _attach(self, slot: int, item) -> None:
        """Copy a prefilled session into an idle slot: row copies into the
        pool's static tensors on the tick stream, after the admission's
        device work (its event).  The prefill's audio was already emitted;
        only live sessions with budget left get here."""
        session, frame, state1, max_gen, ms1, fetch = item
        if session.cancelled:
            session.chunks.put(None)
            return
        t = self._ticker
        state, bufs = t._slot(self.B)
        stream = t.own_stream()
        if stream is not None:
            stream.wait_event(fetch.event)
        _copy_row(state.cache, state1.cache, slot, 0)
        state.pos[slot:slot + 1].copy_(state1.pos)
        bufs.frame[slot:slot + 1].copy_(frame)
        bufs.done[slot] = False
        bufs.temperature[slot] = session.temperature
        bufs.topk[slot] = session.topk
        ms = self._mimi_state
        _copy_row((ms.upsample, ms.tf_pos, ms.seanet), (ms1.upsample, ms1.tf_pos, ms1.seanet),
                  slot, 0)
        _copy_row(ms.tf_cache, ms1.tf_cache, slot, 1)  # (L, B, ...)
        if stream is not None:
            # made on the admission stream, read here: not reused before this
            # stream is done with them
            for x in itertools.chain(_tensors(state1), _tensors(ms1), (frame,)):
                x.record_stream(stream)
        self._sessions[slot] = session
        self._budget[slot] = max_gen - 1

    def _emit_session(self, session: Session, frames: np.ndarray, pcm: np.ndarray):
        """Audio-emission bookkeeping shared by the tick and admission threads:
        TTFA on first audio, frame counters, chunk delivery."""
        if session.first_audio_at is None:
            session.first_audio_at = time.time()
            self.metrics.record("ttfa_s", session.first_audio_at - session.submitted_at)
        with self._lock:
            self._frames_total += frames.shape[0]
        session.frames_out.append(frames)
        session.chunks.put(pcm)

    def _finish_session(self, session: Session):
        session.finished_at = time.time()
        self.metrics.record("session_s", session.finished_at - session.submitted_at)
        session.chunks.put(None)

    def _emit(self, slot: int, frames: np.ndarray, pcm: np.ndarray):
        session = self._sessions[slot]
        if session is None or frames.shape[0] == 0:
            return
        self._emit_session(session, frames, pcm)

    def _finish(self, slot: int):
        session = self._sessions[slot]
        if session is not None:
            self._finish_session(session)
        self._sessions[slot] = None
        _, bufs = self._ticker._slot(self.B)
        bufs.done[slot] = True
        self._budget[slot] = 0

    def _loop(self):
        with _on(self._ticker):
            while self._running:
                try:
                    self._tick()
                except Exception as e:  # never die silently: unblock every session
                    self._inflight = None
                    # slot-attached sessions are lost (their state lived in the
                    # pool); host-only cleanup first
                    for slot in range(self.B):
                        s = self._sessions[slot]
                        if s is not None:
                            s.error = e
                            self._finish_session(s)
                            self._sessions[slot] = None
                        self._budget[slot] = 0
                    log.exception("serving tick failed")
                    # queued sessions survive: their B=1 states do not depend on
                    # the pool, which is reset here
                    try:
                        self._reset_pool_state()
                    except Exception:
                        # the device is gone: the backlog can never be served
                        log.exception("pool reset failed; failing queued sessions")
                        self._terminate_queued(e)
                    time.sleep(0.1)
            # read the last launched tick so final chunks reach their listeners
            if self._inflight is not None:
                try:
                    self._process(self._inflight)
                except Exception:
                    log.exception("reading the last tick failed")
                self._inflight = None

    def _tick(self):
        # attach prefilled sessions to idle slots: row copies enqueued after the
        # tick in flight, which no longer reads freed slots' outputs
        for slot in range(self.B):
            if self._sessions[slot] is None and not self._ready.empty():
                try:
                    item = self._ready.get_nowait()
                except queue.Empty:
                    break
                try:
                    self._attach(slot, item)
                except Exception as e:
                    # the popped session is in neither _sessions nor _ready, so
                    # the recovery cannot see it: end it here
                    s = item[0]
                    s.error = e
                    s.chunks.put(None)
                    raise

        active = [s for s in self._sessions if s is not None]
        if not active:
            if self._inflight is not None:
                self._process(self._inflight)
                self._inflight = None
            else:
                time.sleep(0.005)
            return

        # tick sizes {chunk, 3}; emission clips to each slot's budget in
        # _process, so the last tick of a session decodes at most n-1 frames
        # that nobody hears
        n = self._tick_size()
        greedy = all(csm_model.is_greedy(s.topk) for s in active)
        t = self._ticker
        frames, valid, done, pcm, self._mimi_state = t._serve_tick(
            self.B, n, t._utterance_seed(None), greedy, self._mimi_state)
        # launched before the previous tick is read: the host waits for that
        # tick only while this one runs.  Emission bookkeeping is taken at
        # launch: a session attached later gets none of this tick's audio
        cur = (_Fetch([frames, valid, done, pcm]), n, list(self._sessions), self._budget.copy())
        self.metrics.record("tick_frames", n)  # frame-steps launched, B rows each
        for slot in range(self.B):
            if self._sessions[slot] is not None:
                self._budget[slot] -= n
        if self._inflight is not None:
            self._process(self._inflight)
        self._inflight = cur

    # the attach-priority cap applies only while the admission backlog is at
    # most this deep: a shallow (interactive) backlog gets 3-frame ticks so a
    # prefill lands quickly, a deep (bulk) one keeps full ticks, since its
    # sessions wait for slots anyway
    ATTACH_PRIORITY_MAX_BACKLOG = 4

    def _tick_size(self) -> int:
        """Frames of the next tick: ``chunk``, or 3 while a shallow admission
        backlog waits."""
        backlog = self._pending.qsize() + self._ready.qsize() + self._admitting + self._parked
        if 0 < backlog <= self.ATTACH_PRIORITY_MAX_BACKLOG:
            return min(self.chunk, 3)
        return self.chunk

    def _process(self, inflight):
        """Read and emit one launched tick (lag 1 behind its launch)."""
        fetch, n, sessions, budget = inflight
        frames_np, valid_np, done_np, pcm_np = fetch.wait()
        hop = self._ticker._hop
        for slot in range(self.B):
            session = sessions[slot]
            if session is None or session is not self._sessions[slot]:
                continue  # freed or replaced since launch
            if session.cancelled:
                self._finish(slot)
                continue
            # clip to the session's budget at launch: the tick is sized by the
            # longest budget, and frames past a slot's budget must not reach
            # its listener
            take = int(min(budget[slot], n))
            vmask = valid_np[:take, slot]
            n_emit = int(vmask.sum())  # valid frames are a prefix
            self._emit(slot, frames_np[:take, slot][vmask].astype(np.int32),
                       pcm_np[slot, :n_emit * hop])
            if done_np[slot] or budget[slot] - n <= 0:
                self._finish(slot)
