"""The pool's spans as the readers read them (``harness/spans.py``): the
union of device spans and the window cut on synthetic spans, and the
frame step's parts; and every reader of them returning None where there is nothing to read: the tiny
bench on the CPU, and a program whose sessions keep no spans."""

from types import SimpleNamespace

import pytest

from benchmark import run as bench_run
from benchmark.harness import spans, specs, trace
from conftest import BENCH

READERS = ("backbone_step_ms", "codebook_step_ms", "mimi_step_ms", "tick_launch_ms",
           "emit_lag_ms", "slot_wait_ms", "admission_device_ms", "stream_idle_pct.chat",
           "stream_idle_pct.narration")


def _span(name, start, end, cause=1):
    return SimpleNamespace(name=name, start=start, end=end, cause=cause)


def _tick(tid, t0, n=2, frame=0.030, backbone=0.010, mimi=0.008, copies=0.001):
    """A stamped tick whose device work starts at ``t0``: n frames of
    ``frame`` s (``backbone`` of it in the backbone graph), then Mimi and
    the copies; launched 5 ms before, read 1 ms after its fetch."""
    b = [t0 + i * frame for i in range(n)]
    loop = t0 + n * frame
    stamps = {"backbone": b, "sample": [x + backbone for x in b], "loop": [loop],
              "mimi": [loop + mimi], "fetch": [loop + mimi + copies]}
    fetch = stamps["fetch"][0]
    return SimpleNamespace(id=tid, n=n, live=(1,), stamps=stamps,
                           launch=_span("launch", t0 - 0.005, t0 - 0.004, tid),
                           read=_span("read", fetch - 0.002, fetch + 0.001, tid))


def _run(sessions, t0=0.0, t1=10.0 + trace.TRACE_S, traced=True):
    reqs = [SimpleNamespace(session=s) for s in sessions]
    return SimpleNamespace(requests=reqs, t0=t0, t1=t1, trace=object() if traced else None)


def _session(spans_, ticks):
    return SimpleNamespace(spans=spans_, ticks=ticks)


def test_the_window_stops_where_the_profiled_sub_window_starts():
    run = _run([], t0=2.0, t1=12.0)
    assert spans.window(run) == (2.0, 12.0 - trace.TRACE_S)
    assert spans.window(_run([], traced=False)) is None
    assert spans.window(_run([], t0=0.0, t1=trace.TRACE_S)) is None


def test_covered_seconds_are_the_union_cut_to_the_window():
    intervals = [(0.5, 2.0), (1.0, 3.0), (4.0, 5.0), (9.0, 12.0), (-1.0, 0.2)]
    # [0.5, 3] + [4, 5] + [9, 10] inside [0, 10], and [0, 0.2] from the first
    assert spans.covered_s(intervals, 0.0, 10.0) == pytest.approx(2.5 + 1.0 + 1.0 + 0.2)
    assert spans.covered_s([], 0.0, 1.0) == 0.0


def test_the_step_parts_and_the_idle_share_from_synthetic_ticks():
    # ticks back to back from 1.0 s: each 2 × 30 ms frames + 9 ms, then a
    # 100 ms stretch with nothing on the card, and one tick past the window
    ticks, t = [], 1.0
    for i in range(1, 6):
        ticks.append(_tick(i, t))
        t = ticks[-1].stamps["fetch"][0] + (0.1 if i == 3 else 0.0)
    late = _tick(6, 10.5)
    admission = _span("admission", 0.90, 1.02)
    run = _run([_session([admission], ticks[:3]), _session([], ticks[2:] + [late])])
    assert [x.id for x in spans.window_ticks(run)] == [1, 2, 3, 4, 5]
    assert spans.step_ms(run, "backbone") == pytest.approx(10.0)
    assert spans.step_ms(run, "codebook") == pytest.approx(20.0)
    assert spans.step_ms(run, "mimi") == pytest.approx(4.0)
    # five ticks of 69 ms and the admission's 100 ms before the first; the
    # tick past the window is cut off
    covered = spans.covered_s(spans.device_spans(run), 0.0, 10.0)
    assert covered == pytest.approx(5 * 0.069 + 0.10)
    assert spans.idle_pct(run) == pytest.approx(100.0 * (1 - covered / 10.0))
    one = _tick(9, 2.0)
    assert not spans.stamped(SimpleNamespace(**dict(vars(one), n=3)))


def test_the_readers_read_synthetic_spans():
    ticks = [_tick(i, 1.0 + 0.1 * i) for i in range(1, 4)]
    s = _session([_span("slot_wait", 0.5, 0.6), _span("admission", 0.5, 0.52)], ticks)
    run = _run([s])
    got = {name: specs.reader(BENCH, name).read(run, name)
           for name in READERS}
    assert got["backbone_step_ms"] == pytest.approx(10.0)
    assert got["tick_launch_ms"] == pytest.approx(0.5)
    assert got["emit_lag_ms"] == pytest.approx(1.0)
    assert got["slot_wait_ms"] == pytest.approx(100.0)
    assert got["admission_device_ms"] == pytest.approx(20.0)
    assert 0.0 < got["stream_idle_pct.chat"] == got["stream_idle_pct.narration"] < 100.0


def test_the_readers_find_nothing_in_a_program_without_spans():
    """The program before the spans: its sessions have neither ``spans``
    nor ``ticks``; the readers return None and raise nothing."""
    run = _run([SimpleNamespace(text="x")])
    bench = BENCH
    for name in READERS:
        assert specs.reader(bench, name).read(run, name) is None, name


def test_the_readers_return_none_on_the_tiny_bench(tiny_bench):
    """On the CPU there is no trace and no device stamp: every reader of
    the spans returns None, in a run that kept its spans."""
    bench, bj = tiny_bench
    cell = specs.load_cell("tiny-chat", bench, bj)
    out = bench_run.run_cell(cell, 3000000001, 1.0, True, device="cpu")
    run = out["run"]
    assert any(s.spans for s in spans.sessions(run))  # the host spans are there
    for name in READERS:
        assert specs.reader(bench, name).read(run, name) is None, name
    run.trace = object()  # even with a window: no device stamps on the CPU
    run.t1 = run.t0 + trace.TRACE_S + 1.0
    for name in READERS:
        assert specs.reader(bench, name).read(run, name) is None, name
