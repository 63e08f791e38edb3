"""The serving pool's spans and device stamps (``runtime/serving.py``,
``utils/profiling.py``) at the tiny f32 flavor on the CPU.

Each request's spans come in order on ``time.perf_counter``'s clock, every
chunk names the tick that made it, a tick record holds its frame count
and live sessions, a failed admission and a cancelled session close their
spans, frames are bit-equal with the spans switched off (which keeps
nothing), the spans' series reach ``metrics_summary``, tick records go
with their sessions, and ``DeviceClock``'s bracket holds on fake events
(each side's tightest bound wins, a time maps through the middle, drift
is re-anchored).  On the CPU
there are no device stamps: the stamps' arithmetic is held here on fake
events."""

import gc
import time
import weakref
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from sesameai_tts_tpu_torch.models import csm as csm_model
from sesameai_tts_tpu_torch.runtime.loader import build_generator
from sesameai_tts_tpu_torch.runtime.loader import test_tiny_spec as tiny_spec
from sesameai_tts_tpu_torch.runtime.serving import BatchedTTSServer, Session, Tick, _Admitted
from sesameai_tts_tpu_torch.utils.profiling import DeviceClock, Metrics, Span, Stamp

WAIT = 120  # seconds, every blocking wait
GREEDY = dict(temperature=1.0, topk=1)
REQUEST_ORDER = ("queued", "prefill", "handover", "slot_wait", "attach")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small eager ops: one torch thread per test worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def gen():
    return build_generator(tiny_spec(), device="cpu")


@pytest.fixture
def started(gen):
    """Servers a test builds and starts, stopped however it ends."""
    made = []

    def start(**kw):
        srv = BatchedTTSServer(gen, **dict(dict(slots=2, chunk_frames=4), **kw))
        srv.start()
        made.append(srv)
        return srv

    yield start
    for srv in made:
        srv.stop()


def _idle(srv):
    """Wait until the pool has read its last tick."""
    deadline = time.monotonic() + WAIT
    while (srv._inflight is not None or any(srv._sessions)) and time.monotonic() < deadline:
        time.sleep(0.01)
    assert srv._inflight is None


def _serve(srv, n=3, ms=800, **kw):
    sessions = [srv.submit(f"utterance number {i} here", max_audio_length_ms=ms,
                           **(kw or GREEDY)) for i in range(n)]
    for s in sessions:
        s.audio(timeout=WAIT)
    _idle(srv)
    return sessions


def _by_name(session):
    out = {}
    for sp in session.spans:
        out.setdefault(sp.name, []).append(sp)
    return out


def test_request_spans_come_in_order_on_one_clock(started):
    srv = started()
    t_before = time.perf_counter()
    sessions = _serve(srv)
    t_after = time.perf_counter()
    assert len({s.id for s in sessions}) == len(sessions) and min(s.id for s in sessions) >= 0
    for s in sessions:
        spans = _by_name(s)
        for name in REQUEST_ORDER + ("finished",):
            assert len(spans[name]) == 1, (name, s.spans)
        assert all(sp.cause == s.id for sp in s.spans if sp.name != "chunk")
        assert all(t_before <= sp.start <= sp.end <= t_after for sp in s.spans)
        assert spans["queued"][0].start == s.submitted_at
        seq = [spans[name][0] for name in REQUEST_ORDER]
        for a, b in zip(seq, seq[1:]):
            assert a.end <= b.start, (a, b)
        first, *rest = spans["chunk"]
        handover = spans["handover"][0]
        assert first.cause == 0 and handover.start <= first.start <= first.end <= handover.end
        assert rest and spans["attach"][0].end <= rest[0].start
        assert all(a.end <= b.start for a, b in zip(rest, rest[1:]))
        assert rest[-1].end <= spans["finished"][0].start
        assert s.spans[-1].name == "finished" and s.finished_at <= spans["finished"][0].end


def test_every_chunk_names_the_tick_that_made_it(started):
    srv = started()
    sessions = _serve(srv)
    ticks = {t.id: t for s in sessions for t in s.ticks}
    assert min(ticks) >= 1
    for s in sessions:
        chunks = [sp for sp in s.spans if sp.name == "chunk"]
        assert len(chunks) == len(s.frames_out)
        assert chunks[0].cause == 0
        mine = {t.id for t in s.ticks}
        for sp in chunks[1:]:
            assert sp.cause in mine and s.id in ticks[sp.cause].live
        # each chunk after the first comes from a later tick than the last
        causes = [sp.cause for sp in chunks[1:]]
        assert causes == sorted(set(causes))


def test_a_tick_records_its_frames_and_live_sessions(started):
    srv = started()
    sessions = _serve(srv, n=3, ms=1200)
    ticks = sorted({t.id: t for s in sessions for t in s.ticks}.values(), key=lambda t: t.id)
    assert len(ticks) == int(srv.metrics.summary()["tick_frames"]["count"])
    assert sum(t.n for t in ticks) == srv.metrics.summary()["tick_frames"]["total"]
    for t in ticks:
        assert t.n in (srv.chunk, 3)
        assert 1 <= len(t.live) <= srv.B
        live = [s for s in sessions if s.id in t.live]
        assert len(live) == len(t.live) and all(t in s.ticks for s in live)
        assert t.launch.name == "launch" and t.read.name == "read"
        assert t.launch.cause == t.read.cause == t.id
        assert t.launch.end <= t.read.start
        assert t.stamps == {} and t.events == []  # no device stamps on the CPU
    for s in sessions:  # the frames a session heard came from its ticks
        assert sum(f.shape[0] for f in s.frames_out) <= 1 + sum(t.n for t in s.ticks)


def test_a_failed_admission_and_a_cancelled_session_close_their_spans(started):
    srv = started()
    bad = srv.submit("x " * 3000, max_audio_length_ms=480)
    with pytest.raises(ValueError, match="Inputs too long"):
        bad.audio(timeout=WAIT)
    assert [sp.name for sp in bad.spans] == ["queued", "finished"]
    assert bad.spans[0].end <= bad.spans[1].start
    long = srv.submit("a very long narration request", max_audio_length_ms=30_000, **GREEDY)
    assert long.chunks.get(timeout=WAIT) is not None
    long.cancel()
    long.audio(timeout=WAIT)
    _idle(srv)
    names = [sp.name for sp in long.spans]
    assert names[-1] == "finished" and names.count("finished") == 1
    assert long.spans[-1].start >= max(sp.end for sp in long.spans[:-1])


def test_frames_are_bit_equal_with_spans_off_and_off_keeps_nothing(started):
    on, off = started(), started(spans=False)
    texts = ["first utterance", "a second one to say"]
    got = {}
    for srv in (on, off):
        got[srv.spans] = []
        for text in texts:  # one at a time: the same ticks on both pools
            s = srv.submit(text, max_audio_length_ms=960, **GREEDY)
            pcm = s.audio(timeout=WAIT)
            got[srv.spans].append((np.concatenate(s.frames_out), pcm, s))
        _idle(srv)
    for (f_on, p_on, s_on), (f_off, p_off, s_off) in zip(got[True], got[False]):
        np.testing.assert_array_equal(f_on, f_off)
        np.testing.assert_array_equal(p_on, p_off)
        assert s_on.spans and s_on.ticks
        assert s_off.spans == [] and s_off.ticks == []
    assert off._clock is None
    series = set(off.metrics_summary()["series"])
    assert series == {"ttfa_s", "session_s", "tick_frames"}


def test_the_spans_series_appear_in_metrics_summary(started):
    srv = started()
    sessions = _serve(srv, n=2)
    series = srv.metrics_summary()["series"]
    for name in ("queue_wait_s", "prefill_s", "handover_s", "slot_wait_s", "attach_s",
                 "chunk_emit_s", "tick_launch_s", "tick_read_s"):
        assert series[name]["count"] >= 1, name
    assert series["queue_wait_s"]["count"] == len(sessions)
    chunks = sum(len(s.frames_out) for s in sessions)
    assert series["chunk_emit_s"]["count"] == chunks
    for name in ("admission_device_s", "tick_device_s", "tick_backbone_s", "emit_lag_s"):
        assert name not in series  # device stamps only on a card


def test_tick_records_go_with_their_sessions(started):
    srv = started()
    sessions = _serve(srv, n=3)
    refs = [weakref.ref(t) for s in sessions for t in s.ticks]
    assert refs and all(r() is not None for r in refs)
    del sessions
    deadline = time.monotonic() + 5.0  # the admission threads poll every 50 ms
    while any(r() is not None for r in refs) and time.monotonic() < deadline:
        gc.collect()
        time.sleep(0.05)
    assert all(r() is None for r in refs)


def test_serve_tick_calls_its_stamps_between_the_parts_and_keeps_its_frames(gen):
    t = gen.clone(seed=5)
    K = t._cfg.audio_num_codebooks
    out, labels = [], []
    for stamps in (None, labels.append):
        state, bufs = t._slot(2)
        csm_model.load_state(state)
        bufs.frame.zero_()
        bufs.done.zero_()
        csm_model.set_sampling(bufs, 0.8, 5)
        ms = t._mimi.init_decode_state(2, t._mimi_dtype, t.device)
        kw = {} if stamps is None else {"stamps": stamps}
        out.append(t._serve_tick(2, 3, 11, False, ms, **kw)[:4])
    assert labels == ["backbone", "sample"] * 3 + ["loop", "mimi"]
    for a, b in zip(*out):
        assert torch.equal(a, b)
    assert out[0][0].shape == (3, 2, K)


# -- the stamps' arithmetic, on fake events --------------------------------------


class _Device:
    """A fake card: its clock is ``now`` seconds."""

    def __init__(self):
        self.now = 0.0

    def event(self):
        dev = self

        class Event:
            t = None

            def record(self):
                self.t = dev.now

            def elapsed_time(self, other):
                return (other.t - self.t) * 1e3

        return Event()


def _recorded(dev, clock, t, issued):
    """A stamp of ``clock`` that the card reached at ``t``, issued by the
    host at ``issued``."""
    dev.now = t
    return Stamp(clock.stamp().event, issued)


def _fetched(dev, t, issued):
    """A fetch's own event (not from the pool), reached at ``t``."""
    dev.now = t
    ev = dev.event()
    ev.record()
    return Stamp(ev, issued)


def test_device_clock_maps_stamps_through_the_tightest_bound():
    """Each side of the bracket keeps its tightest bound; a time maps
    through the bracket's middle (no drift allowed here)."""
    dev = _Device()
    clock = DeviceClock(True, drift=0.0, make_event=dev.event)
    host = lambda t: t + 100.0  # noqa: E731  (host = device + 100 s)
    assert clock.slack() is None  # before any wait
    # a wait that returned 5 ms late on a fetch issued 3 ms before the card
    # reached it: the offset lies in [100 − 3 ms, 100 + 5 ms]
    (at,) = clock.settle([], _fetched(dev, 1.0, host(1.0) - 3e-3), host(1.0) + 5e-3)
    assert clock.slack() == pytest.approx(8e-3, abs=1e-12)
    assert at == pytest.approx(host(1.0) + 1e-3, abs=1e-12)
    # a stamp issued 0.2 ms before the card reached it tightens the lower side;
    # a later, tighter wait the upper one
    stamps = [_recorded(dev, clock, 1.1, host(1.1) - 5e-3),
              _recorded(dev, clock, 1.15, host(1.15) - 2e-4)]
    times = clock.settle(stamps, _fetched(dev, 1.2, host(1.2) - 9e-3), host(1.2) + 1e-3)
    assert clock.slack() == pytest.approx(1.2e-3, abs=1e-12)
    assert times == pytest.approx([host(t) + 4e-4 for t in (1.1, 1.15, 1.2)], abs=1e-12)
    # looser bounds later change nothing
    (at,) = clock.settle([], _fetched(dev, 1.4, host(1.4) - 0.05), host(1.4) + 0.02)
    assert clock.slack() == pytest.approx(1.2e-3, abs=1e-12)
    assert at == pytest.approx(host(1.4) + 4e-4, abs=1e-12)
    assert DeviceClock(False).stamp() is None and DeviceClock(False).event() is None


def test_device_clock_keeps_its_bound_and_reuses_the_other_stamps():
    """``settle`` gives the stamps' events back to the pool, but the one it
    keeps as the lower bound, which a later stamp must not record over."""
    dev = _Device()
    clock = DeviceClock(True, drift=0.0, make_event=dev.event)
    stamps = [_recorded(dev, clock, t, 100.0 + t - lead)
              for t, lead in ((1.0, 0.01), (1.1, 1e-5), (1.2, 0.03))]
    clock.settle(stamps, _fetched(dev, 1.3, 101.3 - 0.02), 101.3 + 1e-4)
    again = [_recorded(dev, clock, 2.0 + i, 0.0).event for i in range(3)]
    assert {id(e) for e in again[:2]} == {id(stamps[0].event), id(stamps[2].event)}
    assert again[2] is not stamps[1].event and stamps[1].event.t == 1.1
    assert clock.slack() == pytest.approx(1e-4 + 1e-5, abs=1e-12)


def test_device_clock_reanchors_as_the_clocks_drift():
    """The host's clock runs 50 ppm fast against the card's: bounds age by
    the drift allowed (100 ppm), so new ones replace them, the bracket
    holds, and readings stay within its half width; with none allowed the
    first exact bound stays and the readings drift."""
    rng = np.random.default_rng(0)
    drift = 50e-6

    def host(t):
        return 100.0 + t * (1.0 + drift)

    errors = {}
    for allowed in (1e-4, 0.0):
        dev = _Device()
        clock = DeviceClock(True, drift=allowed, make_event=dev.event)
        clock.settle([], _fetched(dev, 0.0, host(0.0)), host(0.0))  # exact bounds
        worst = 0.0
        for k in range(1, 200):  # a wait every 0.3 s for a minute
            t = 0.3 * k
            stamp = _recorded(dev, clock, t - 0.15, host(t - 0.15) - rng.uniform(10e-6, 30e-6))
            got, _ = clock.settle([stamp], _fetched(dev, t, host(t) - 0.01),
                                  host(t) + rng.uniform(10e-6, 30e-6))
            err = abs(got - host(t - 0.15))
            if allowed:
                assert 0.0 <= clock.slack() < 1e-4 and err <= clock.slack() / 2 + 1e-9
            worst = max(worst, err)
        errors[allowed] = worst
    assert errors[1e-4] < 1e-4
    assert errors[0.0] > 1e-3  # without the allowance the first bound stays


def test_device_clock_keeps_an_old_tight_bound_over_new_loose_ones():
    """Waits that begin long after their events (a pool whose reads lag a
    tick) give loose upper bounds: a tight one from seconds before, aged by
    the drift allowed, still wins, so the bracket stays narrow."""
    dev = _Device()
    clock = DeviceClock(True, drift=1e-4, make_event=dev.event)
    host = lambda t: t + 100.0  # noqa: E731
    clock.settle([], _fetched(dev, 0.0, host(0.0) - 1e-5), host(0.0) + 1e-5)
    for k in range(1, 20):  # 0.3 s apart, each wait 100 ms late
        t = 0.3 * k
        stamp = _recorded(dev, clock, t - 0.2, host(t - 0.2) - 0.05)
        got, _ = clock.settle([stamp], _fetched(dev, t, host(t) - 0.2), host(t) + 0.1)
        assert clock.slack() == pytest.approx(2e-5 + 2 * 1e-4 * (t + 0.1), rel=1e-6)
        assert abs(got - host(t - 0.2)) <= clock.slack() / 2 + 1e-9


def test_read_stamps_splits_a_tick_on_the_hosts_clock(gen):
    """``_read_stamps`` with a fake card: the tick's stamps land on the
    host's clock, with the host's times of their issue and the clock's
    bracket, and its device parts go into the series."""
    dev = _Device()
    srv = BatchedTTSServer(gen, slots=2, chunk_frames=4)
    srv._clock = DeviceClock(True, drift=0.0, make_event=dev.event)
    tick = Tick(1, 2)
    # the first stamp is reached as it is issued (the card idle), the rest late
    for t, label, issued in ((0.0, "backbone", 5.0), (0.010, "sample", 5.001),
                             (0.030, "backbone", 5.002), (0.041, "sample", 5.003),
                             (0.062, "loop", 5.004), (0.070, "mimi", 5.005)):
        dev.now = t
        tick.events.append((label, Stamp(srv._clock.stamp().event, issued)))

    class Fetch:
        event = dev.event()
        issued, waited = 5.006, 5.0725

    dev.now = 0.0725
    Fetch.event.record()
    srv._read_stamps(tick, Fetch)
    assert tick.events == []
    st = tick.stamps
    assert [round(x - 5.0, 6) for x in st["backbone"]] == [0.0, 0.03]
    assert round(st["fetch"][0] - 5.0, 6) == 0.0725
    assert tick.issued["sample"] == [5.001, 5.003] and tick.issued["fetch"] == [5.006]
    assert tick.slack == pytest.approx(0.0, abs=1e-9)
    got = {k: v["total"] for k, v in srv.metrics.summary().items()}
    assert got["tick_backbone_s"] == pytest.approx(0.010 + 0.011)
    assert got["tick_codebook_s"] == pytest.approx(0.020 + 0.021)
    assert got["tick_mimi_s"] == pytest.approx(0.008)
    assert got["tick_device_s"] == pytest.approx(0.0725)
    assert got["clock_slack_s"] == pytest.approx(0.0, abs=1e-9)


def test_an_admission_maps_its_device_span_through_the_clock(gen):
    """``_complete_admission`` with a fake card: the "admission" span runs
    from the prefill's stamp to the fetch event, on the host's clock."""
    dev = _Device()
    srv = BatchedTTSServer(gen, slots=2, chunk_frames=4)
    srv._clock = DeviceClock(True, drift=0.0, make_event=dev.event)
    srv._running = False  # the hand-over to the tick thread ends at once
    session = Session(text="x", id=1)
    dev.now = 0.5
    start = Stamp(srv._clock.stamp().event, 10.5)
    fetch = SimpleNamespace(event=dev.event(), issued=10.52, waited=10.6005)
    dev.now = 0.6
    fetch.event.record()
    frame = np.zeros((1, 1), np.int32)
    fetch.wait = lambda: (np.array([False]), frame, np.zeros((1, 4), np.float32))
    srv._complete_admission(_Admitted(session, None, None, 10, None, fetch, start))
    (adm,) = [sp for sp in session.spans if sp.name == "admission"]
    # the offset lies in [10.0, 10.0005] s: the middle of the bracket maps it
    assert adm.start == pytest.approx(10.50025) and adm.end == pytest.approx(10.60025)
    assert srv.metrics.summary()["admission_device_s"]["total"] == pytest.approx(0.1)


def test_metrics_record_span_adds_its_seconds_to_the_series():
    m = Metrics()
    span = m.record_span("wait_s", Span("wait", 1.0, 1.25, 7))
    assert span.seconds == 0.25 and span.cause == 7
    assert m.summary()["wait_s"]["total"] == 0.25
