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

On a mesh (a Generator built with ``mesh=``) the server is SPMD: every rank
builds the same server and calls ``start()``.  Rank 0 is the front: it owns
``submit``, the sessions, the Mimi decode and whatever serves HTTP; the
other ranks' ``start()`` runs a follower loop until rank 0 stops.  Each
tick rank 0 broadcasts a fixed-layout int64 plan on a CPU gloo group (the
op, the tick's frames, seed and greedy flag, the admissions with their
slot, sampling, seed, budget and prompt rows, the freed slots); every rank
then runs the admissions and the tick on its rows of the pool (its 'dp'
share when dp divides the slots, else all of them), and the codes reach
rank 0 through an all_reduce of a zero-filled (frames, slots, K) buffer,
each row written by one rank.  The admissions run on the tick threads
between ticks, in plan order: on rank 0, which emits each first chunk, on
the ranks that hold the admission's slot, and with tp > 1 on rank 0's tp
group, whose collectives meet in the same order on every rank of the
group (a pipelined admission thread would issue them in another order on
each rank).

Spans (``spans=True``, the default): every time is ``time.perf_counter``
seconds.  A session keeps its own ``Session.spans`` (``Span`` name, start,
end, cause): "queued" (submit → the dispatch thread takes it), "prefill"
(the host's part of ``_prefill_admission``), "admission" (on the card: a
stamp on the admission stream before the prefill → the fetch event after
its first chunk), "handover" (that fetch waited → the first chunk emitted,
the session about to be queued for a slot), "slot_wait" (→ ``_attach``
begins), "attach", one "chunk" per PCM chunk emitted (its cause the id of
the ``Tick`` that made it, 0 for the admission's first chunk) and
"finished" (the last chunk, error or cancel → the end put on the queue).
Each tick is a ``Tick`` record that every session live at its launch
keeps in ``Session.ticks``: its host launch span, device stamps on the
tick stream around its frames and Mimi decode, and the host's read and
emission of it.  Device stamps are events from a ``DeviceClock``, read
only after the fetch waits the pool makes anyway (the tick's in
``_process``, the admission's in ``_complete_admission``); no graph holds
one.  Each span's seconds also go into the server's ``metrics`` series
(``metrics_summary``).  On the CPU and on a mesh there are no device
stamps.  ``spans=False`` stamps and keeps nothing.
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import queue
import threading
import time
from dataclasses import dataclass, field
from datetime import timedelta
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from sesameai_tts_tpu_torch.models import csm as csm_model
from sesameai_tts_tpu_torch.ops import sampling
from sesameai_tts_tpu_torch.runtime.generator import FRAME_MS, Generator
from sesameai_tts_tpu_torch.utils.profiling import DeviceClock, Metrics, Span, Stamp

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
    # time.perf_counter seconds
    submitted_at: float = field(default_factory=time.perf_counter)
    first_audio_at: Optional[float] = None
    finished_at: Optional[float] = None
    id: int = -1  # the submit order (a server's ids are unique)
    spans: List[Span] = field(default_factory=list)  # the module docstring's
    ticks: List["Tick"] = field(default_factory=list)  # those it was live at

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


@dataclass(eq=False)
class Tick:
    """One tick of the pool (module docstring), kept by the sessions live at
    its launch and dropped with them.

    ``launch``: the host's ``_serve_tick`` call; ``read``: the host's read
    and emission of the tick in ``_process``.  ``stamps``: device times on
    the host's clock by label, filled once the tick's fetch has been
    waited for: "backbone" and "sample" (before each frame's replay of
    that graph), "loop" (after the frames' copies), "mimi" (after the
    batched Mimi decode and its cast) and "fetch" (the copies to the host
    done); ``issued``: the host's times just before each was recorded, by
    the same labels (the card reaches a stamp no earlier); ``slack``: the
    width of the clock's bracket when they were mapped (``DeviceClock``)."""

    id: int
    n: int  # frame-steps
    live: tuple = ()  # ids of the sessions live at launch
    launch: Optional[Span] = None
    read: Optional[Span] = None
    stamps: Dict[str, List[float]] = field(default_factory=dict)
    issued: Dict[str, List[float]] = field(default_factory=dict)
    slack: Optional[float] = None
    events: list = field(default_factory=list, repr=False)  # (label, Stamp) until read


class _Fetch:
    """Device tensors copied to pinned host memory without blocking, behind
    an event on the current stream (``event``, or a new one, recorded just
    after host time ``issued``); ``wait`` syncs on that event alone and
    notes when it returned (``waited``)."""

    def __init__(self, tensors: Sequence[torch.Tensor], event=None):
        self.event = None
        self.issued = self.waited = None
        if tensors[0].device.type == "cpu":
            self._host = list(tensors)
            return
        self._host = []
        for t in tensors:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            self._host.append(h)
        self.event = torch.cuda.Event() if event is None else event
        self.issued = time.perf_counter()
        self.event.record()

    def wait(self) -> List[np.ndarray]:
        if self.event is not None:
            self.event.synchronize()
        self.waited = time.perf_counter()
        return [h.numpy() for h in self._host]


def _tensors(tree):
    """The tensors of a nested tuple / list / NamedTuple (None leaves skipped)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for t in tree:
            yield from _tensors(t)


# the plan of one mesh tick (module docstring): a header of op, frames, tick
# seed, greedy, admissions, frees; then per admission slot, seed,
# temperature (f64 bits), topk, budget, prompt rows; then the freed slots
_OP_TICK, _OP_RESET, _OP_STOP = 0, 1, 2
_HEAD, _ADMIT = 6, 6


class _Admission(NamedTuple):
    slot: int
    seed: int
    temperature: float
    topk: int
    max_gen: int
    tokens: np.ndarray  # (S, K+1) prompt rows
    mask: np.ndarray


class _Admitted(NamedTuple):
    """A dispatched admission: its B=1 prefill and first chunk on the device,
    their fetch last (None on a mesh, where the tick thread fetched them)."""

    session: "Session"
    frame: torch.Tensor
    state1: csm_model.CSMState
    max_gen: int
    ms1: object  # the codec state after the first chunk
    fetch: Optional["_Fetch"]
    start: Optional[Stamp] = None  # before the prefill (spans on the card)


class _Launched(NamedTuple):
    """A launched tick waiting to be read: its fetch, frame-steps, the
    sessions and budgets at launch, and its record (None without spans)."""

    fetch: _Fetch
    n: int
    sessions: list
    budget: np.ndarray
    tick: Optional[Tick]


class _Plan(NamedTuple):
    op: int
    n: int = 0
    seed: int = 0
    greedy: bool = True
    admits: tuple = ()
    frees: tuple = ()


# each session span's series in the server's metrics ("finished" has none:
# a finish records session_s)
_SERIES = {"queued": "queue_wait_s", "prefill": "prefill_s", "admission": "admission_device_s",
           "handover": "handover_s", "slot_wait": "slot_wait_s", "attach": "attach_s",
           "chunk": "chunk_emit_s"}


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
    decode in flight.  ``spans`` switches the spans and device stamps of
    the module docstring on (the default) or off."""

    def __init__(self, generator: Generator, slots: int = 4, chunk_frames: int = 10,
                 max_pending: Optional[int] = None, spans: bool = True):
        self.gen = generator
        self.spans = spans
        self._clock = DeviceClock(generator.device.type == "cuda") if spans else None
        self._tick_ids = itertools.count(1)  # 0 is an admission's first chunk
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
        # the pool rows this rank decodes: all of them, or its 'dp' share
        self._rows = generator._rows(slots)
        self._mesh = generator.mesh
        self._front = True  # this rank takes requests
        if self._mesh is not None:
            mesh = self._mesh
            self._front = dist.get_rank() == 0
            # rank 0's plans and the codes: a CPU group whatever the default
            # backend (an idle follower waits in the broadcast, hence the timeout)
            self._plan_group = dist.new_group(backend="gloo", timeout=timedelta(days=7))
            # one rank writes each row of the gathered codes: tp rank 0 of the
            # dp row that holds it (dp row 0 for a replicated pool)
            self._writes = mesh.get_local_rank("tp") == 0 and (
                len(self._rows) < slots or mesh.get_local_rank("dp") == 0)
            self._dp_row0 = mesh.get_local_rank("dp") == 0
            self._freed: List[int] = []  # rank 0: slots freed since the last plan
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
        self._started_at = time.perf_counter()
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

    def _local(self, slot: int) -> Optional[int]:
        """The pool row of ``slot`` on this rank, None if another rank holds it."""
        return slot - self._rows.start if slot in self._rows else None

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
        pool).  On a tp mesh every rank calls it (its prefills meet in
        all_reduces)."""
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
        local card.)  Exposed as GET /healthz?deep=1.  Not on a tp mesh: its
        ticks would need every rank."""
        if self._canary._tp is not None:
            raise RuntimeError("link_canary: a tp mesh's tick needs every rank; time the "
                               "serving ticks instead")
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
        if not self._front:
            raise RuntimeError("a server on a mesh takes requests on rank 0")
        s = Session(text=text, **kw)
        if self._mesh is not None and s.cached_context is not None:
            raise ValueError("cached_context is a handle of rank 0's state; on a mesh pass "
                             "the context segments")
        prio = s.priority
        if prio is None:
            prio = 0 if s.max_audio_length_ms <= self.INTERACTIVE_MAX_MS else 1
        with self._backlog_cv:  # atomic with stop()'s _running flip: no session
            # may be enqueued after the final drain (its listener would block)
            while True:
                if not self._running:
                    raise RuntimeError("server is not running (call start())")
                try:
                    s.id = next(self._seq)
                    self._pending.put_nowait((prio, s.id, s))
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
        """TTFA percentiles, frame and session counters, occupancy, and the
        process's sampler launches (the ``topk_sample`` kernel's: 32 a
        sampled frame-step; the plain path's calls on the card: none): the
        /metrics HTTP surface."""
        occupied = sum(1 for s in self._sessions if s is not None)
        return {
            "sessions_total": self._sessions_total,
            "frames_total": self._frames_total,
            "slots": self.B,
            "slots_occupied": occupied,
            "uptime_s": round(time.perf_counter() - self._started_at, 3),
            "series": self.metrics.summary(),
            "sampler_launches": {"topk_sample": sampling.topk_sample.launches,
                                 "sample_topk_plain": sampling.sample_topk_plain.launches},
        }

    def start(self):
        """Capture every graph serving can replay (no capture happens once the
        threads run), then start the dispatch, completion and tick threads.
        On a mesh rank 0 starts its tick thread (it admits too) and returns;
        another rank runs the follower loop here and returns when rank 0
        stops the server."""
        self._capture_all()
        if not self._front:
            self._follow()
            return
        self._running = True
        if self._mesh is None:
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
                self._close(s, err)

    def stop(self):
        """Stop the threads (on a mesh the tick thread broadcasts the stop to
        the other ranks) and end every session still queued or attached."""
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
                self._sessions[slot] = None
                self._close(s, err)

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
                start = None if self._clock is None else self._clock.stamp()
                h0 = time.perf_counter()
                frame, state1, done1, max_gen = a._prefill_admission(
                    session.text, session.speaker, list(session.context),
                    session.cached_context, max_gen, session.temperature, session.topk,
                    a._utterance_seed(None))
                self._span(session, "prefill", h0, time.perf_counter())
                pcm0, ms1 = a._first_chunk(frame)
                # (done, frame, PCM) in one fetch: an admission's only host sync;
                # its event also orders the pool's copy of state1 after the prefill
                fetch = _Fetch([done1, frame, pcm0], self._fetch_event())
        except Exception as e:
            self._close(session, e)
            return None
        return _Admitted(session, frame, state1, max_gen, ms1, fetch, start)

    def _complete_admission(self, inflight) -> None:
        """Stage 2: wait for the dispatched first chunk, emit first audio, hand
        the session to the tick thread (or finish it on EOS)."""
        session, max_gen, fetch = inflight.session, inflight.max_gen, inflight.fetch
        try:
            done1_np, frame_np, wav0 = fetch.wait()
        except Exception as e:
            self._close(session, e)
            return
        if inflight.start is not None:  # spans on the card
            a0, a1 = self._clock.settle([inflight.start], Stamp(fetch.event, fetch.issued),
                                        fetch.waited)
            self._span(session, "admission", a0, a1)
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
        # a full _ready is a wait for a slot: the hand-over ends here
        self._span(session, "handover", fetch.waited, time.perf_counter())
        placed = False
        while self._running:  # bounded queue: block without hanging stop()
            try:
                self._ready.put(inflight, timeout=0.2)
                placed = True
                break
            except queue.Full:
                continue
        if not placed:  # stop() raced the bounded put: end the session
            self._close(session, RuntimeError("server stopped"))

    def _dispatch_loop(self):
        """Admission stage 1 (own thread): enqueue session N+1's prefill while
        session N's first chunk is fetched on the completion thread."""
        while self._running:
            session = inflight = None  # nothing ended stays alive while it waits
            try:
                _, _, session = self._pending.get(timeout=0.05)
            except queue.Empty:
                continue
            self._span(session, "queued", session.submitted_at, time.perf_counter())
            with self._backlog_cv:  # a backlog place just freed: wake one
                self._backlog_cv.notify()  # parked submit(wait=True)
            if session.cancelled:
                self._close(session)
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
                self._close(session, RuntimeError("server stopped"))
                self._add_admitting(-1)

    def _completion_loop(self):
        """Admission stage 2 (own thread): fetch dispatched first chunks in
        dispatch order and hand the sessions to the tick thread."""
        while self._running:
            inflight = None  # nothing ended stays alive while it waits
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
        session, frame, state1, max_gen, ms1, fetch = item[:6]
        h0 = time.perf_counter()
        handed = next((sp.end for sp in reversed(session.spans) if sp.name == "handover"), None)
        if handed is not None:
            self._span(session, "slot_wait", handed, h0)
        if session.cancelled:
            self._close(session)
            if self._mesh is not None:  # the other ranks attached it
                self._freed.append(slot)
            return
        t = self._ticker
        stream = t.own_stream()
        if stream is not None and fetch is not None:
            stream.wait_event(fetch.event)
        self._attach_state(slot, frame, state1, session.temperature, session.topk)
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
        self._span(session, "attach", h0, time.perf_counter())

    def _attach_state(self, slot: int, frame, state1, temperature, topk) -> None:
        """Row copies of a prefilled B=1 state into the pool's row of ``slot``,
        where this rank holds it."""
        row = self._local(slot)
        if row is None:
            return
        state, bufs = self._ticker._slot(self.B)
        _copy_row(state.cache, state1.cache, row, 0)
        state.pos[row:row + 1].copy_(state1.pos)
        bufs.frame[row:row + 1].copy_(frame)
        bufs.done[row] = False
        bufs.temperature[row] = temperature
        bufs.topk[row] = topk

    # -- spans (the module docstring) --------------------------------------------

    def _span(self, session: Session, name: str, start: Optional[float],
              end: Optional[float], cause: Optional[int] = None) -> None:
        """Keep a span of ``session`` (caused by itself unless ``cause``) and
        record its seconds in its series; nothing without spans or times."""
        if not self.spans or start is None or end is None:
            return
        span = Span(name, start, end, session.id if cause is None else cause)
        session.spans.append(span)
        if name in _SERIES:
            self.metrics.record_span(_SERIES[name], span)

    def _fetch_event(self):
        """A fetch's event: a timing one with spans on the card, else None
        (``_Fetch`` makes its own)."""
        return None if self._clock is None else self._clock.event()

    def _tick_record(self, n: int) -> Optional[Tick]:
        return Tick(next(self._tick_ids), n) if self.spans else None

    def _stamper(self, tick: Optional[Tick]):
        """``tick``'s ``stamps`` callback for ``_serve_tick``; None without
        the tick or a card."""
        if tick is None or not self._clock.on_device:
            return None
        clock, events = self._clock, tick.events

        def stamp(label: str) -> None:
            events.append((label, clock.stamp()))

        return stamp

    def _launched(self, tick: Optional[Tick], h0: float) -> None:
        """``tick`` was launched from ``h0`` to now; every session live now
        keeps it."""
        if tick is None:
            return
        live = [s for s in self._sessions if s is not None]
        tick.live = tuple(s.id for s in live)
        tick.launch = self.metrics.record_span(
            "tick_launch_s", Span("launch", h0, time.perf_counter(), tick.id))
        for s in live:
            s.ticks.append(tick)

    def _read_stamps(self, tick: Tick, fetch: _Fetch) -> None:
        """After the tick's fetch returned: its device stamps onto the host's
        clock (``Tick.stamps``, ``issued``, ``slack``) and into the series."""
        events, tick.events = tick.events, []
        if not events:  # the CPU, a mesh: host spans only
            return
        clock = self._clock
        times = clock.settle([sp for _, sp in events], Stamp(fetch.event, fetch.issued),
                             fetch.waited)
        st, issued = tick.stamps, tick.issued
        for (label, sp), t in zip(events, times):
            st.setdefault(label, []).append(t)
            issued.setdefault(label, []).append(sp.issued)
        fetched = times[-1]
        st["fetch"], issued["fetch"] = [fetched], [fetch.issued]
        tick.slack = clock.slack()
        backbone, sample = st["backbone"], st["sample"]
        loop, mimi = st["loop"][0], st["mimi"][0]
        m = self.metrics
        m.record("tick_device_s", fetched - backbone[0])
        m.record("tick_backbone_s", sum(s - b for b, s in zip(backbone, sample)))
        m.record("tick_codebook_s", sum(b - s for s, b in zip(sample, backbone[1:] + [loop])))
        m.record("tick_mimi_s", mimi - loop)
        m.record("clock_slack_s", tick.slack)

    def _close(self, session: Session, error: Optional[Exception] = None) -> None:
        """End ``session`` with no more audio: an error, a cancel or a stop."""
        if error is not None:
            session.error = error
        self._finished(session)
        session.chunks.put(None)

    def _finished(self, session: Session) -> None:
        """The "finished" span: from the session's last span to now."""
        if self.spans:
            now = time.perf_counter()
            last = max((sp.end for sp in session.spans), default=session.submitted_at)
            self._span(session, "finished", last, now)

    # -- emission ---------------------------------------------------------------------

    def _emit_session(self, session: Session, frames: np.ndarray, pcm: np.ndarray,
                      cause: int = 0):
        """Audio-emission bookkeeping shared by the tick and admission threads:
        TTFA on first audio, frame counters, chunk delivery; the chunk's span
        names the tick that made it (``cause``; 0: the admission)."""
        t0 = time.perf_counter()
        if session.first_audio_at is None:
            session.first_audio_at = t0
            self.metrics.record("ttfa_s", session.first_audio_at - session.submitted_at)
        with self._lock:
            self._frames_total += frames.shape[0]
        session.frames_out.append(frames)
        session.chunks.put(pcm)
        self._span(session, "chunk", t0, time.perf_counter(), cause)

    def _finish_session(self, session: Session):
        session.finished_at = time.perf_counter()
        self.metrics.record("session_s", session.finished_at - session.submitted_at)
        self._finished(session)
        session.chunks.put(None)

    def _emit(self, slot: int, frames: np.ndarray, pcm: np.ndarray, cause: int = 0):
        session = self._sessions[slot]
        if session is None or frames.shape[0] == 0:
            return
        self._emit_session(session, frames, pcm, cause)

    def _finish(self, slot: int):
        session = self._sessions[slot]
        if session is not None:
            self._finish_session(session)
        self._sessions[slot] = None
        _, bufs = self._ticker._slot(self.B)
        row = self._local(slot)
        if row is not None:
            bufs.done[row] = True
        if self._mesh is not None:
            self._freed.append(slot)
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
                    # the pool, which is reset here (on every rank of a mesh)
                    try:
                        if self._mesh is not None:
                            self._freed.clear()
                            self._broadcast_plan(_Plan(_OP_RESET))
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
            if self._mesh is not None:
                self._broadcast_plan(_Plan(_OP_STOP))

    def _tick(self):
        if self._mesh is not None:
            return self._tick_mesh()
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
                    self._close(item[0], e)
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
        tick = self._tick_record(n)
        stamps = self._stamper(tick)
        launch = (self.B, n, t._utterance_seed(None), greedy, self._mimi_state)
        h0 = time.perf_counter()
        frames, valid, done, pcm, self._mimi_state = (
            t._serve_tick(*launch) if stamps is None else t._serve_tick(*launch, stamps=stamps))
        self._launched(tick, h0)
        # launched before the previous tick is read: the host waits for that
        # tick only while this one runs.  Emission bookkeeping is taken at
        # launch: a session attached later gets none of this tick's audio
        cur = _Launched(_Fetch([frames, valid, done, pcm], self._fetch_event()), n,
                        list(self._sessions), self._budget.copy(), tick)
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
        fetch, n, sessions, budget, tick = inflight
        h0 = time.perf_counter()
        frames_np, valid_np, done_np, pcm_np = fetch.wait()
        if tick is not None:
            self._read_stamps(tick, fetch)
        cause = 0 if tick is None else tick.id
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
                       pcm_np[slot, :n_emit * hop], cause)
            if done_np[slot] or budget[slot] - n <= 0:
                self._finish(slot)
        if tick is not None:
            tick.read = self.metrics.record_span(
                "tick_read_s", Span("read", h0, time.perf_counter(), tick.id))
            if "fetch" in tick.stamps:
                self.metrics.record("emit_lag_s", tick.read.end - tick.stamps["fetch"][0])

    # -- the pool on a mesh (module docstring) -------------------------------------

    def _plan_len(self) -> int:
        return _HEAD + self.B * _ADMIT + self.B

    def _broadcast_plan(self, plan: _Plan) -> None:
        """Rank 0: send ``plan``; its prompt rows follow as one int64 array
        (each admission's tokens, then its mask)."""
        buf = np.zeros(self._plan_len(), np.int64)
        buf[:_HEAD] = (plan.op, plan.n, plan.seed, int(plan.greedy), len(plan.admits),
                       len(plan.frees))
        rows = []
        for i, a in enumerate(plan.admits):
            buf[_HEAD + i * _ADMIT:_HEAD + (i + 1) * _ADMIT] = (
                a.slot, a.seed, np.float64(a.temperature).view(np.int64), a.topk, a.max_gen,
                a.tokens.shape[0])
            rows += [a.tokens.reshape(-1), a.mask.reshape(-1)]
        end = _HEAD + self.B * _ADMIT
        buf[end:end + len(plan.frees)] = plan.frees
        dist.broadcast(torch.from_numpy(buf), src=0, group=self._plan_group)
        if rows:
            dist.broadcast(torch.from_numpy(np.concatenate(rows).astype(np.int64)), src=0,
                           group=self._plan_group)

    def _receive_plan(self) -> _Plan:
        """A follower: the next plan from rank 0."""
        head = torch.empty(self._plan_len(), dtype=torch.int64)
        dist.broadcast(head, src=0, group=self._plan_group)
        buf = head.numpy()
        op, n, seed, greedy, n_admit, n_free = (int(x) for x in buf[:_HEAD])
        entries = buf[_HEAD:_HEAD + n_admit * _ADMIT].reshape(n_admit, _ADMIT)
        width = self._ticker._cfg.audio_num_codebooks + 1
        admits = []
        if n_admit:
            flat = torch.empty(int(entries[:, 5].sum()) * width * 2, dtype=torch.int64)
            dist.broadcast(flat, src=0, group=self._plan_group)
            flat, at = flat.numpy(), 0
            for slot, a_seed, temp, topk, max_gen, S in entries:
                cut = S * width
                tokens = flat[at:at + cut].reshape(S, width)
                mask = flat[at + cut:at + 2 * cut].reshape(S, width).astype(bool)
                at += 2 * cut
                admits.append(_Admission(int(slot), int(a_seed),
                                         float(np.int64(temp).view(np.float64)), int(topk),
                                         int(max_gen), tokens, mask))
        end = _HEAD + self.B * _ADMIT
        return _Plan(op, n, seed, bool(greedy), tuple(admits),
                     tuple(int(x) for x in buf[end:end + n_free]))

    def _follow(self) -> None:
        """A follower's loop: run rank 0's plans until it stops."""
        with _on(self._ticker):
            while True:
                plan = self._receive_plan()
                if plan.op == _OP_STOP:
                    return
                if plan.op == _OP_RESET:
                    self._reset_pool_state()
                    continue
                self._run_plan(plan, {})

    def _prefill_planned(self, a: _Admission):
        """An admission from the plan's rows on the admission clone, on the
        tick thread → (frame (1, K), B=1 state, EOS on its frame (a host
        bool: every rank of the plan agrees), budget)."""
        frame, state1, done1, max_gen = self._admitter._prefill_admission(
            None, None, None, None, a.max_gen, a.temperature, a.topk, a.seed,
            rows=(a.tokens, a.mask))
        return frame, state1, bool(done1[0]), max_gen

    def _admit_on_front(self, a: _Admission, session: Session) -> None:
        """Rank 0: the planned admission's prefill (beside the ranks that run
        it too), its first chunk emitted, then the session attached or, on
        EOS or a one-frame budget, finished."""
        frame, state1, done1, max_gen = self._prefill_planned(a)
        pcm0, ms1 = self._admitter._first_chunk(frame)
        frame_np, wav0 = _Fetch([frame, pcm0]).wait()
        if not done1:
            self._emit_session(session, frame_np.astype(np.int32), wav0[0])
        if done1 or max_gen <= 1:
            self._finish_session(session)
            return
        self._attach(a.slot, _Admitted(session, frame, state1, max_gen, ms1, None))

    def _run_plan(self, plan: _Plan, front: dict):
        """Every rank: free the plan's slots, run its admissions (``front``:
        rank 0's sessions by slot), then tick
        ``plan.n`` frames on this rank's rows and gather the codes → (frames
        (n, B, K), valid (n, B), done (B,)) CPU tensors on rank 0, None
        elsewhere or without a tick."""
        t = self._ticker
        _, bufs = t._slot(self.B)
        for slot in plan.frees:
            row = self._local(slot)
            if row is not None:
                bufs.done[row] = True
        for a in plan.admits:
            try:
                if self._front:
                    self._admit_on_front(a, front[a.slot])
                elif self._dp_row0 or self._local(a.slot) is not None:
                    frame, state1, done1, max_gen = self._prefill_planned(a)
                    if not done1 and max_gen > 1:
                        self._attach_state(a.slot, frame, state1, a.temperature, a.topk)
            except Exception as e:
                # the admission fails alone, and alike on every rank (its
                # inputs are the plan's), so no rank leaves the plan's order
                log.exception("admission to slot %d failed", a.slot)
                if self._front:
                    self._close(front[a.slot], e)
        if plan.n == 0:
            return None
        frames, valid = t._replay_frames(self.B, plan.seed, plan.n, 0, plan.greedy)
        K = frames.shape[-1]
        gathered = torch.zeros(plan.n * self.B * (K + 1) + self.B, dtype=torch.int64)
        if self._writes:
            rows = slice(self._rows.start, self._rows.stop)
            codes = gathered[:-self.B].view(plan.n, self.B, K + 1)
            codes[:, rows, :K] = frames.cpu()
            codes[:, rows, K] = valid.cpu().long()
            gathered[-self.B:][rows] = bufs.done.cpu().long()
        dist.all_reduce(gathered, group=self._plan_group)
        if not self._front:
            return None
        codes = gathered[:-self.B].view(plan.n, self.B, K + 1)
        return codes[..., :K], codes[..., K].bool(), gathered[-self.B:].bool()

    def _plan_admissions(self) -> tuple:
        """Rank 0: the admissions of the next plan, the next sessions of the
        backlog, tokenized here, one per idle slot → (the plan's admissions,
        {slot: session})."""
        idle = [s for s in range(self.B) if self._sessions[s] is None]
        a = self._admitter
        admits, front = [], {}
        while idle:
            try:
                _, _, session = self._pending.get_nowait()
            except queue.Empty:
                break
            self._span(session, "queued", session.submitted_at, time.perf_counter())
            with self._backlog_cv:  # a backlog place just freed
                self._backlog_cv.notify()
            if session.cancelled:
                self._close(session)
                continue
            try:  # a prompt too long for the cache fails here, never planned
                tokens, mask = a._tokenize_prompt(session.text, session.speaker,
                                                  list(session.context))
                max_gen = a._room(tokens.shape[0], int(session.max_audio_length_ms / FRAME_MS))
            except Exception as e:
                self._close(session, e)
                continue
            slot = idle.pop(0)
            admits.append(_Admission(slot, a._utterance_seed(None), session.temperature,
                                     session.topk, max_gen, tokens, mask))
            front[slot] = session
        return tuple(admits), front

    def _tick_mesh(self):
        """Rank 0's tick on a mesh: plan the admissions and the frames,
        broadcast the plan, run it beside the other ranks, then decode the
        gathered codes through the batched streaming Mimi decode (lag 1, as
        on one card)."""
        admits, front = self._plan_admissions()
        active = [s for s in self._sessions if s is not None]
        if not active and not admits:
            frees, self._freed = tuple(self._freed), []
            if frees:  # idle slots go back to done on the ranks that hold them
                plan = _Plan(_OP_TICK, frees=frees)
                self._broadcast_plan(plan)
                self._run_plan(plan, {})
            elif self._inflight is not None:
                self._process(self._inflight)
                self._inflight = None
            else:
                time.sleep(0.005)
            return
        t = self._ticker
        n = self._tick_size()
        greedy = all(csm_model.is_greedy(s.topk) for s in active + list(front.values()))
        frees, self._freed = tuple(self._freed), []
        plan = _Plan(_OP_TICK, n, t._utterance_seed(None), greedy, admits, frees)
        tick = self._tick_record(n)  # host spans only
        h0 = time.perf_counter()
        self._broadcast_plan(plan)
        gathered = self._run_plan(plan, front)
        frames, valid, done = (x.to(t.device) for x in gathered)
        wav, self._mimi_state = t._mimi.decode_streaming(t._mimi_params, frames.permute(1, 2, 0),
                                                         self._mimi_state)
        self._launched(tick, h0)
        cur = _Launched(_Fetch([frames, valid, done, wav[:, 0].float()], self._fetch_event()), n,
                        list(self._sessions), self._budget.copy(), tick)
        self.metrics.record("tick_frames", n)
        for slot in range(self.B):
            if self._sessions[slot] is not None:
                self._budget[slot] -= n
        if self._inflight is not None:
            self._process(self._inflight)
        self._inflight = cur
