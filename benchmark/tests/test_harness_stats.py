"""The end-to-end arithmetic on hand-made request logs."""

import json

import numpy as np
import pytest

from benchmark.harness import stats, texts, trace
from benchmark.harness.client import Request
from conftest import BENCH, TINY


def _req(scheduled, chunks, error=None):
    r = Request(text="x", voice=0, budget_ms=1000.0, temperature=0.8, topk=40,
                scheduled=scheduled)
    r.chunk_log = [(t, 1920) for t in chunks]
    r.error = error
    return r


def test_percentile_interpolates_between_ranks():
    assert stats.percentile([], 95) is None
    assert stats.percentile([3.0], 95) == 3.0
    xs = list(range(1, 101))  # 1..100
    assert abs(stats.percentile(xs, 95) - 95.05) < 1e-9
    assert stats.percentile([1, 2, 3, 4], 50) == 2.5


def test_first_audio_is_timed_from_the_scheduled_send():
    # sent late (scheduled 1.0, first chunk 1.5): the lateness counts
    r = _req(1.0, [1.5, 1.8])
    assert stats.ttfa_s([r], 0.0, 10.0, missed_s=99.0) == [0.5]


def test_a_tail_is_over_all_requests_in_the_window_and_misses_count():
    inside = [_req(float(i), [i + 0.1]) for i in range(19)]
    outside = _req(20.0, [20.1])  # scheduled after the window: not counted
    unanswered = _req(5.5, [])
    failed = _req(6.5, [6.6], error=RuntimeError("x"))
    waits = stats.ttfa_s(inside + [outside, unanswered, failed], 0.0, 20.0, missed_s=30.0)
    assert len(waits) == 21
    assert sorted(waits)[-2:] == [30.0, 30.0]
    assert stats.percentile(waits, 95) == 30.0


def test_gaps_count_by_the_later_chunk_and_a_rate_over_the_whole_window():
    r = _req(0.0, [0.5, 0.8, 1.1, 2.6])
    assert [round(g, 6) for g in stats.chunk_gaps_s([r], 0.0, 2.0)] == [0.3, 0.3]
    assert stats.samples_in_window([r], 0.0, 2.0) == 3 * 1920


def test_a_stall_inside_the_window_moves_the_tail_and_the_rate():
    steady = [_req(0.0, [0.1 * k for k in range(1, 100)]) for _ in range(4)]
    stalled = [_req(0.0, [0.1 * k for k in range(1, 40)] + [0.1 * k + 2.0 for k in range(40, 80)])
               for _ in range(4)]
    gap_steady = stats.percentile(stats.chunk_gaps_s(steady, 0.0, 10.0), 100)
    gap_stalled = stats.percentile(stats.chunk_gaps_s(stalled, 0.0, 10.0), 100)
    assert abs(gap_steady - 0.1) < 1e-9 and abs(gap_stalled - 2.1) < 1e-9
    assert stats.samples_in_window(stalled, 0.0, 8.0) < stats.samples_in_window(steady, 0.0, 8.0)


def _k(a, b, name="k"):
    return trace.Kernel(name, a, b)


def test_busy_time_counts_overlaps_once_and_clips_to_the_window():
    recs = [_k(0.0, 1.0), _k(0.5, 1.5), _k(2.0, 3.0), _k(-1.0, 0.2), _k(3.5, 9.0)]
    assert trace.merged([(k.start, k.end) for k in recs]) == [(-1.0, 1.5), (2.0, 3.0),
                                                             (3.5, 9.0)]
    assert abs(trace.busy_s(recs, 0.0, 4.0) - (1.5 + 1.0 + 0.5)) < 1e-12


def test_idle_gaps_are_named_by_the_host_calls_in_flight():
    recs = [_k(0.0, 1.0), _k(1.2, 2.0), _k(2.9, 3.0)]
    host = [trace.HostCall("read", 0.9, 1.15, 0, ()), trace.HostCall("tick", 1.15, 1.3, 10, ()),
            trace.HostCall("prefill", 2.1, 2.3, 0, ())]
    gaps = trace.idle_gaps(recs, 0.0, 3.5, host)
    assert [g[0] for g in gaps] == ["prefill", "none", "read+tick"]
    assert [round(g[1], 9) for g in gaps] == [0.9, 0.5, 0.2]


def test_top_ops_sum_by_name():
    recs = [_k(0, 1, "a"), _k(1, 3, "b"), _k(3, 4, "a"), _k(4, 4.5, "c")]
    assert trace.top_ops(recs, top=2) == [("a", 2.0), ("b", 2.0)]


@pytest.mark.parametrize("config,rows", [(BENCH / "configs" / "csm-1b-int8.json", r)
                                         for r in (12, 17, 25, 28, 60, 114)]
                         + [(TINY / "configs" / "csm-tiny-int8.json", r) for r in (4, 9, 12)])
def test_a_text_takes_the_rows_it_is_sized_to(config, rows):
    cfg = json.loads(config.read_text())
    rng = np.random.default_rng(rows)
    for speaker in range(4):
        for n_sentences in (1, 2, 6):
            text = texts.sized(cfg, speaker, rows, n_sentences, rng)
            got = texts.ref_tokens.text_rows(cfg["tokenizer"], text, speaker,
                                             cfg["audio_num_codebooks"],
                                             cfg["text_vocab_size"])[0].shape[0]
            assert rows <= got <= rows + 2, (text, got)
