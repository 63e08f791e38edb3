"""chunk_gap_p95_ms: the 95th percentile of the gaps between consecutive
PCM chunks of one request, over all requests, by the time the later
chunk reached the client in the window: what a listener hears as a
stall."""

from benchmark.harness import stats


def read(run, name):
    p = stats.percentile(stats.chunk_gaps_s(run.requests, run.t0, run.t1), 95)
    return None if p is None else 1e3 * p
