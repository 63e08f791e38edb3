"""admission_host_ms: the median over the window of the admission
clone's own ``prefill_s`` series (the program's counter: the host's part
of each admission, from its start to its work enqueued), in ms."""


def read(run, name):
    p50 = run.counters.get("admission_p50_s")
    return None if p50 is None else 1e3 * p50
