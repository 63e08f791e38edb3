"""The port's batched serving (``runtime/serving.py``) at the tiny f32
flavor, against the JAX package's ``BatchedTTSServer`` fed the same weights.

Greedy sessions through a 2-slot pool give the JAX pool's frames exactly
and the port's own ``generate_frames``, their PCM within 1e-5 of its peak
of the JAX pool's; a topk=1 session in a sampled batch keeps its greedy
frames; a session whose room in the KV cache is smaller than a tick, and a
pool run past ``max_seq_len`` frame-steps with one slot idle, serve and
equal JAX.  Then the scheduler's behaviours, as ``tests/test_serving.py``
holds them for the JAX package: priority admission, the backlog-aware tick
size, a parked ``submit(wait=True)``, ``ServerSaturated``, cancel,
one-frame sessions, an admission error between healthy sessions, recovery
after a failed tick, stop ending listeners, and the soak invariant
(delivered PCM equals ``decode_audio`` of the delivered frames).

Every server is stopped in a fixture finalizer or a ``finally``; every
blocking wait has a timeout."""

import random
import threading
import time

import jax
import numpy as np
import pytest
import torch

from sesameai_tts_tpu.runtime.loader import build_generator as j_build
from sesameai_tts_tpu.runtime.loader import test_tiny_spec as j_tiny_spec
from sesameai_tts_tpu.runtime.serving import BatchedTTSServer as JServer
from sesameai_tts_tpu_torch.codec.mimi import Mimi, mimi_test_tiny
from sesameai_tts_tpu_torch.convert import from_jax_params
from sesameai_tts_tpu_torch.core.config import csm_test_tiny
from sesameai_tts_tpu_torch.ops import sampling
from sesameai_tts_tpu_torch.runtime.frames import Segment
from sesameai_tts_tpu_torch.runtime.generator import Generator
from sesameai_tts_tpu_torch.runtime.serving import BatchedTTSServer, ServerSaturated
from sesameai_tts_tpu_torch.tokenizer.text import TinyHashTokenizer

# f32 PCM relative to its peak, as tests/test_torch_generator.py
PCM_RTOL = 1e-5
# a KV cache of 128 rows (the --max-positions override) keeps the
# cache-end cases short; the tiny flavor's own is 256
MAX_SEQ = 128
CHUNK = 10
GREEDY = dict(temperature=1.0, topk=1)
WAIT = 120  # seconds, every blocking wait
TEXTS = ["session number zero speaking", "the first one talks now",
         "and number two follows them"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small eager ops: one torch thread per test worker (see
    tests/test_torch_service.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jgen():
    spec = j_tiny_spec()
    spec.csm = spec.csm.replace(max_seq_len=MAX_SEQ)
    return j_build(spec, decode_chunk_frames=4)


@pytest.fixture(scope="module")
def gen(jgen):
    csm = from_jax_params(jax.tree.map(np.asarray, jgen._params))
    mimi = from_jax_params(jax.tree.map(np.asarray, jgen._mimi_params))
    return Generator(csm, csm_test_tiny().replace(max_seq_len=MAX_SEQ), Mimi(mimi_test_tiny()),
                     mimi, TinyHashTokenizer(), decode_chunk_frames=4, device="cpu")


@pytest.fixture(scope="module")
def jpool(jgen):
    srv = JServer(jgen, slots=2, chunk_frames=CHUNK)
    srv.start()
    yield srv
    srv.stop()


@pytest.fixture(scope="module")
def pool(gen):
    srv = BatchedTTSServer(gen, slots=2, chunk_frames=CHUNK)
    srv.warmup()
    srv.start()
    yield srv
    srv.stop()


@pytest.fixture(scope="module")
def server(gen):
    """The scheduler tests' server, as tests/test_serving.py's: 2 slots,
    4-frame ticks."""
    srv = BatchedTTSServer(gen, slots=2, chunk_frames=4)
    srv.start()
    yield srv
    srv.stop()


@pytest.fixture
def started():
    """Servers a test builds itself, stopped however it ends."""
    made = []

    def start(gen, **kw):
        srv = BatchedTTSServer(gen, **kw)
        made.append(srv)
        return srv

    yield start
    for srv in made:
        srv.stop()


def _frames(s, K=8):
    return np.concatenate(s.frames_out) if s.frames_out else np.zeros((0, K), np.int32)


def _close_pcm(got, want):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=PCM_RTOL * np.abs(want).max())


def _serve(srv, texts, sequential=False, **kw):
    """Each text's session on ``srv`` → [(frames, PCM)]: all submitted at
    once, or each after the previous one ended."""
    out, sessions = [], []
    for text in texts:
        sessions.append(srv.submit(text, **kw))
        if sequential:
            out.append((sessions[-1].audio(timeout=WAIT), sessions[-1]))
    if not sequential:
        out = [(s.audio(timeout=WAIT), s) for s in sessions]
    return [(_frames(s), pcm) for pcm, s in out]


# -- against the JAX package ----------------------------------------------------


def test_greedy_pool_equals_jax_pool_and_generate_frames(gen, pool, jpool):
    """3 greedy sessions on 2 slots (the queue is exercised): the port's
    frames equal the JAX pool's and its own B=1 ``generate_frames``; PCM
    within 1e-5 of the peak of the JAX pool's."""
    kw = dict(max_audio_length_ms=1600, **GREEDY)
    got = _serve(pool, TEXTS, **kw)
    want = _serve(jpool, TEXTS, **kw)
    for text, (frames, pcm), (j_frames, j_pcm) in zip(TEXTS, got, want):
        assert frames.dtype == np.int32 and frames.shape[0] > 1
        np.testing.assert_array_equal(frames, j_frames)
        np.testing.assert_array_equal(frames, gen.generate_frames(text, 1, [], **kw))
        _close_pcm(pcm, j_pcm)


def test_greedy_session_in_a_sampled_batch_keeps_its_frames(gen, pool):
    """The pool replays the sampled step while any live session samples; a
    topk=1 session beside sampled ones still gets its greedy frames."""
    flags = []
    real = pool._ticker._serve_tick

    def spy(batch, n, seed, greedy, ms):
        flags.append(greedy)
        return real(batch, n, seed, greedy, ms)

    pool._ticker._serve_tick = spy
    try:
        greedy = pool.submit(TEXTS[0], max_audio_length_ms=1600, **GREEDY)
        sampled = pool.submit(TEXTS[1], max_audio_length_ms=1600, temperature=0.9, topk=5)
        g_pcm = greedy.audio(timeout=WAIT)
        sampled.audio(timeout=WAIT)
    finally:
        pool._ticker._serve_tick = real
    assert False in flags  # some tick ran the sampled step
    np.testing.assert_array_equal(
        _frames(greedy), gen.generate_frames(TEXTS[0], 1, [], max_audio_length_ms=1600,
                                             **GREEDY))
    assert g_pcm.shape[0] == _frames(greedy).shape[0] * gen._hop


def _text_of_rows(gen, rows: int) -> str:
    text = "a " * (rows - 2)
    assert gen._tokenize_prompt(text, 1, [])[0].shape[0] == rows
    return text


def test_room_smaller_than_a_tick_serves_and_equals_jax(gen, pool, jpool):
    """A prompt that leaves 9 rows of KV cache: the budget clamps to 9
    frames, less than a 10-frame tick, so the tick runs past the cache end
    (the port's position saturates where JAX's write clamps); the emitted
    frames are the JAX pool's and ``generate_frames``'."""
    text = _text_of_rows(gen, MAX_SEQ - 9)
    kw = dict(max_audio_length_ms=4000, **GREEDY)
    (frames, pcm), = _serve(pool, [text], **kw)
    (j_frames, j_pcm), = _serve(jpool, [text], **kw)
    assert 1 < frames.shape[0] <= 9
    np.testing.assert_array_equal(frames, j_frames)
    np.testing.assert_array_equal(frames, gen.generate_frames(text, 1, [], **kw))
    _close_pcm(pcm, j_pcm)


def test_pool_past_max_seq_len_frame_steps_with_an_idle_slot(gen, pool, jpool):
    """Sessions one after another on slot 0 for more than ``max_seq_len``
    frame-steps while slot 1 stays idle and keeps stepping: its position
    reaches the cache end and stays there.  Every session serves and
    equals the JAX pool's."""
    texts = [f"sequential session {i} of the long run" for i in range(3)]
    kw = dict(max_audio_length_ms=6000, sequential=True, **GREEDY)
    got = _serve(pool, texts, **kw)
    want = _serve(jpool, texts, **kw)
    assert sum(f.shape[0] for f, _ in got) > MAX_SEQ
    assert pool._ticker._slot(2).state.pos[1] == MAX_SEQ - 1  # saturated, never out of range
    for (frames, pcm), (j_frames, j_pcm) in zip(got, want):
        np.testing.assert_array_equal(frames, j_frames)
        _close_pcm(pcm, j_pcm)


# -- the scheduler --------------------------------------------------------------


def test_chunk_frames_clamped_to_codec_ring(gen):
    """A tick longer than the codec streaming ring's slack clamps at
    construction (the codec would raise on the first tick)."""
    cap = gen._mimi.max_stream_chunk_frames
    assert BatchedTTSServer(gen, slots=2, chunk_frames=cap + 99).chunk == cap


def test_concurrent_sessions_complete(server):
    hop = server.gen._hop
    sessions = [server.submit(f"session number {i} speaking", speaker=i % 2,
                              max_audio_length_ms=480, temperature=0.8, topk=5)
                for i in range(3)]  # 3 sessions > 2 slots: the queue is exercised
    for s in sessions:
        audio = s.audio(timeout=WAIT)
        assert audio.dtype == np.float32 and audio.shape[0] % hop == 0
        assert audio.shape[0] == _frames(s).shape[0] * hop


def test_warmup_covers_the_serving_set_and_captures_nothing_after_start(server):
    """warmup() runs every prefill bucket, the first chunk and the batched
    codec decode at both tick sizes, and leaves a running pool serving;
    start() already made every serving state (graphs on the card), so a
    warmup on a running server makes none."""
    def made(g):
        return {k: id(v.state.pos) for k, v in g._slots.items()}, len(g._graphs)

    before = {id(g): made(g) for g in (server._ticker, server._admitter)}
    times = server.warmup()
    buckets = {b for b in server.gen._prefill_buckets if b <= server.gen.max_seq_len}
    assert {f"prefill_{b}" for b in buckets} | {"first_chunk"} <= set(times)
    assert {f"mimi_tick_b{server.B}_n{n}" for n in {server.chunk, 3}} <= set(times)
    assert all(v >= 0 for v in times.values())
    for g in (server._ticker, server._admitter):
        assert made(g) == before[id(g)]
    s = server.submit("after warmup", max_audio_length_ms=400, topk=5)
    assert s.audio(timeout=WAIT).dtype == np.float32


def test_tick_failure_recovery_resets_the_pool(server):
    """A failed tick ends the attached sessions with its error, resets the
    pool, and the next session serves."""
    ticker = server._ticker
    real = ticker._serve_tick
    calls = {"n": 0}

    def flaky(*a, **k):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("injected tick failure")
        return real(*a, **k)

    ticker._serve_tick = flaky
    try:
        bad = server.submit("dies in the first tick", max_audio_length_ms=2000,
                            temperature=0.8, topk=5)
        with pytest.raises(RuntimeError, match="injected"):
            bad.audio(timeout=WAIT)
    finally:
        ticker._serve_tick = real
    ok = server.submit("recovers after the failure", max_audio_length_ms=480,
                       temperature=0.8, topk=5)
    assert ok.audio(timeout=WAIT).dtype == np.float32


def test_submit_requires_running_server(gen, started):
    """submit() on a server not started, or stopped, raises instead of
    queueing a session no thread would end."""
    srv = started(gen, slots=1, chunk_frames=4)
    with pytest.raises(RuntimeError, match="not running"):
        srv.submit("never served")
    srv.start()
    s = srv.submit("short", max_audio_length_ms=480, temperature=0.8, topk=5)
    assert s.audio(timeout=WAIT).ndim == 1
    srv.stop()
    with pytest.raises(RuntimeError, match="not running"):
        srv.submit("after stop")


def test_synthesize_batch_order_and_errors(server):
    """PCM in input order; an over-long text raises only after the healthy
    utterances were collected."""
    out = server.synthesize_batch(["first utterance", "second one", "third here"],
                                  max_audio_length_ms=480, temperature=0.8, topk=5,
                                  timeout=WAIT)
    assert len(out) == 3
    assert all(a.dtype == np.float32 and a.shape[0] % server.gen._hop == 0 for a in out)
    with pytest.raises(ValueError, match="Inputs too long"):
        server.synthesize_batch(["ok short text", "x " * 3000], max_audio_length_ms=480,
                                temperature=0.8, topk=5, timeout=WAIT)


def test_session_error_propagates(server):
    s = server.submit("x " * 3000, max_audio_length_ms=480)
    with pytest.raises(ValueError, match="Inputs too long"):
        s.audio(timeout=WAIT)


def test_session_cancel_frees_slot(server):
    """cancel() stops the generation; the slot then serves the next session."""
    long = server.submit("a very long narration request", speaker=1,
                         max_audio_length_ms=30_000, temperature=0.8, topk=5)
    assert long.chunks.get(timeout=WAIT) is not None
    long.cancel()
    long.audio(timeout=WAIT)  # drains to the terminating None
    assert _frames(long).shape[0] < 100  # far fewer than its budget: it stopped
    after = server.submit("short one after cancel", max_audio_length_ms=480, temperature=0.8,
                          topk=5)
    assert after.audio(timeout=WAIT).ndim == 1


def test_session_cached_context_equals_inline_context(gen, server):
    """A precomputed voice prefix gives the frames of the same context passed
    inline (greedy: the admission's noise does not matter)."""
    hop = gen._hop
    seg = Segment(speaker=1, text="voice clip",
                  audio=(np.random.default_rng(0).normal(size=2 * hop) * 0.1).astype(np.float32))
    cached = gen.precompute_context_state([seg])
    kw = dict(speaker=1, max_audio_length_ms=480, **GREEDY)
    raw = server.submit("cached context check", context=[seg], **kw)
    via_cache = server.submit("cached context check", cached_context=cached, **kw)
    raw.audio(timeout=WAIT)
    assert len(via_cache.audio(timeout=WAIT)) > 0
    np.testing.assert_array_equal(_frames(raw), _frames(via_cache))


def test_serving_soak_mixed_workload(server):
    """A burst of mixed sessions with cancels and per-session sampling: every
    session ends, and its delivered PCM equals the offline decode of its
    delivered frames (the lag-1 bookkeeping invariant)."""
    gen = server.gen
    hop = gen._hop
    rng = random.Random(7)
    sessions = []
    for i in range(12):
        s = server.submit(f"soak session number {i}", speaker=i % 2,
                          max_audio_length_ms=rng.choice([160, 480, 960, 2000]),
                          temperature=0.7 + 0.1 * (i % 3), topk=1 + (i % 4) * 2)
        sessions.append(s)
        if i % 4 == 1:
            s.cancel()  # some cancel at once (possibly still pending)
    victim = sessions[6]  # cancelled after its first chunk
    chunks = [victim.chunks.get(timeout=WAIT)]
    victim.cancel()
    while chunks[-1] is not None:
        chunks.append(victim.chunks.get(timeout=WAIT))
    got = [c for c in chunks if c is not None]
    victim_audio = np.concatenate(got) if got else np.zeros((0,), np.float32)
    for i, s in enumerate(sessions):
        audio = victim_audio if s is victim else s.audio(timeout=WAIT)
        frames = _frames(s)
        assert audio.shape[0] == frames.shape[0] * hop, f"session {i}"
        if frames.shape[0]:
            assert np.abs(audio - gen.decode_audio(frames)).max() < 2e-4, f"session {i} PCM"


def test_one_frame_session_completes_at_admission(server):
    """A 1-frame budget finishes on the admission thread without a slot:
    audio, finished_at and the session metrics are recorded."""
    s = server.submit("tiny", max_audio_length_ms=80, topk=5)  # max_gen = 1
    assert s.audio(timeout=WAIT).shape[0] in (0, server.gen._hop)
    assert s.finished_at is not None and s.finished_at >= s.submitted_at
    m = server.metrics_summary()
    assert m["series"]["session_s"]["count"] >= 1 and m["sessions_total"] >= 1


def test_metrics_summary_counts_the_sampler_launches(server):
    """/metrics' sampler counts are the process's: on the CPU a sampled
    session runs the plain path, so neither count moves."""
    before = server.metrics_summary()["sampler_launches"]
    assert before == {"topk_sample": sampling.topk_sample.launches,
                      "sample_topk_plain": sampling.sample_topk_plain.launches}
    s = server.submit("sampled", max_audio_length_ms=400, temperature=0.8, topk=5)
    assert s.audio(timeout=WAIT).shape[0] > 0
    assert server.metrics_summary()["sampler_launches"] == before


def test_blocked_dispatch_does_not_delay_completion(server):
    """Dispatch and completion are separate threads: a dispatch that blocks
    does not delay the first chunk the device already finished."""
    gate = threading.Event()
    calls = []
    orig = server._dispatch_admission

    def gated(session):
        calls.append(session)
        if len(calls) == 2:  # the second dispatch stalls
            gate.wait(timeout=60)
        return orig(session)

    server._dispatch_admission = gated
    try:
        a = server.submit("first session", max_audio_length_ms=480, temperature=0.8, topk=5)
        b = server.submit("second session", max_audio_length_ms=480, temperature=0.8, topk=5)
        deadline = time.monotonic() + WAIT
        while a.first_audio_at is None and time.monotonic() < deadline:
            time.sleep(0.01)
        assert a.first_audio_at is not None and not gate.is_set()
    finally:
        gate.set()
        server._dispatch_admission = orig
    assert a.audio(timeout=WAIT).dtype == np.float32
    assert b.audio(timeout=WAIT).dtype == np.float32


def test_admission_error_between_healthy_sessions(server):
    """A failed dispatch mid-pipeline strands neither neighbour."""
    a = server.submit("healthy utterance one", max_audio_length_ms=480, temperature=0.8, topk=5)
    bad = server.submit("x " * 3000, max_audio_length_ms=480)
    b = server.submit("healthy utterance two", max_audio_length_ms=480, temperature=0.8, topk=5)
    assert a.audio(timeout=WAIT).dtype == np.float32
    assert b.audio(timeout=WAIT).dtype == np.float32
    with pytest.raises(ValueError, match="Inputs too long"):
        bad.audio(timeout=WAIT)


def _gated_server(started, gen, **kw):
    """A started server whose dispatch waits on ``release`` → (server,
    order of dispatched sessions, entered, release)."""
    srv = started(gen, **kw)
    order, entered, release = [], threading.Event(), threading.Event()
    orig = srv._dispatch_admission

    def gated(session):
        order.append(session)
        entered.set()
        release.wait(60)
        return orig(session)

    srv._dispatch_admission = gated
    srv.start()
    return srv, order, entered, release


def test_submit_wait_parks_then_saturates_and_unblocks(gen, started):
    """Against a full backlog, submit(wait=False) raises ServerSaturated with
    a Retry-After advisory and submit(wait=True) parks on the condition
    variable; it wakes when the backlog drains or stop() broadcasts."""
    srv, _, entered, release = _gated_server(started, gen, slots=1, chunk_frames=4,
                                             max_pending=1)
    try:
        srv.submit("held by the gate", max_audio_length_ms=160)
        assert entered.wait(WAIT)  # the dispatch worker holds it
        srv.submit("fills the backlog", wait=False, max_audio_length_ms=160)
        with pytest.raises(ServerSaturated) as e:
            srv.submit("one too many", wait=False, max_audio_length_ms=160)
        assert 1.0 <= e.value.retry_after_s <= 30.0
        result = {}

        def blocked():
            try:
                result["s"] = srv.submit("parked", max_audio_length_ms=160)
            except RuntimeError as err:
                result["e"] = err

        t = threading.Thread(target=blocked, daemon=True)
        t.start()
        time.sleep(0.4)
        assert t.is_alive() and not result  # parked, not raising, not spinning
    finally:
        release.set()
        srv.stop()
    t.join(10)
    assert not t.is_alive()
    assert "s" in result or isinstance(result.get("e"), RuntimeError)


def test_tick_size_backlog_aware(gen):
    """3-frame ticks while a shallow backlog waits, full ticks when idle or
    for a deep (bulk) backlog; parked submitters count as backlog."""
    srv = BatchedTTSServer(gen, slots=2, chunk_frames=10)
    assert srv._tick_size() == 10
    srv._admitting = 1
    assert srv._tick_size() == 3
    srv._admitting = 0
    for i in range(srv.ATTACH_PRIORITY_MAX_BACKLOG):
        srv._pending.put_nowait((1, i, None))
    assert srv._tick_size() == 3
    srv._pending.put_nowait((1, 99, None))
    assert srv._tick_size() == 10
    while not srv._pending.empty():
        srv._pending.get_nowait()
    srv._pending.put_nowait((1, 100, None))
    srv._parked = srv.ATTACH_PRIORITY_MAX_BACKLOG
    assert srv._tick_size() == 10  # 1 queued + 4 parked = deep


@pytest.mark.parametrize("case", ["derived", "explicit"])
def test_priority_admission(gen, started, case):
    """Priority-then-FIFO: a short (interactive) request, or a long one
    marked priority 0, submitted behind queued bulk jobs admits first."""
    srv, order, entered, release = _gated_server(started, gen, slots=1, chunk_frames=4)
    try:
        first = srv.submit("holds the admission worker", max_audio_length_ms=4_160)
        assert entered.wait(WAIT)
        bulk = [srv.submit(f"bulk job {i}", max_audio_length_ms=4_160) for i in range(3)]
        if case == "derived":
            vip = srv.submit("quick one", max_audio_length_ms=400)
        else:
            vip = srv.submit("long but marked interactive", max_audio_length_ms=4_160,
                             priority=0)
        release.set()
        for s in (first, *bulk, vip):
            s.audio(timeout=WAIT)
    finally:
        release.set()
    assert [id(s) for s in order] == [id(s) for s in (first, vip, *bulk)]


def test_stop_ends_every_listener(gen, started):
    """stop() ends attached, ready and pending sessions with an error: no
    listener blocks forever."""
    srv = started(gen, slots=1, chunk_frames=4)
    srv.start()
    sessions = [srv.submit(f"long session {i}", max_audio_length_ms=8000, topk=5)
                for i in range(4)]
    assert sessions[0].chunks.get(timeout=WAIT) is not None
    srv.stop()
    stopped = 0
    for s in sessions:
        try:
            s.audio(timeout=WAIT)  # ended normally, or
        except RuntimeError as e:  # ended by stop(); never queue.Empty (a hang)
            assert "stopped" in str(e)
            stopped += 1
    assert stopped >= 2  # the queued ones at least


def test_prewarm_passes_offline_to_generator_warmup(capsys, monkeypatch):
    """``prewarm(..., offline=)`` and ``--no-offline`` reach
    ``Generator.warmup(offline=...)``, as in the JAX package."""
    import inspect

    from sesameai_tts_tpu.service import prewarm as j_prewarm
    from sesameai_tts_tpu_torch.runtime.loader import build_generator, test_tiny_spec
    from sesameai_tts_tpu_torch.service import prewarm

    assert list(inspect.signature(prewarm.prewarm).parameters) == \
        list(inspect.signature(j_prewarm.prewarm).parameters)
    seen = []
    monkeypatch.setattr(BatchedTTSServer, "warmup", lambda self: {"serve": 0.0})
    monkeypatch.setattr(Generator, "warmup",
                        lambda self, **kw: seen.append(kw) or {"gen": 0.0})
    gen = build_generator(test_tiny_spec(), device="cpu")
    assert prewarm.prewarm(gen, 2, 4, offline=False) == {"serve": 0.0, "gen": 0.0}
    assert prewarm.prewarm(gen, 2, 4)["gen"] == 0.0
    assert [kw["offline"] for kw in seen] == [False, True]
    for argv, want in (([], True), (["--no-offline"], False)):
        assert prewarm.main(["--device", "cpu", "--flavor", "test-tiny", "--slots", "2",
                             "--max-positions", "128", *argv]) == 0
        assert seen[-1]["offline"] is want
    capsys.readouterr()


def test_prewarm_runs_on_the_cpu_when_asked(capsys):
    """``sesame-tts-torch-prewarm --device cpu`` runs the serve-start warm-up
    set and prints its JSON line (no ``cache_dir``: nothing persists but
    the kernels, and the CPU has none to build); without a card the
    default device raises."""
    import json

    from sesameai_tts_tpu_torch.service import prewarm

    assert prewarm.main(["--device", "cpu", "--flavor", "test-tiny", "--slots", "2",
                         "--max-positions", "128"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == {"programs", "build_s", "warmup_wall_s", "slots", "chunk_frames"}
    assert line["slots"] == 2 and line["chunk_frames"] == 10 and line["programs"] > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            prewarm.main(["--flavor", "test-tiny"])
