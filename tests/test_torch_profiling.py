"""The port's ``utils/profiling.py`` as ``tests/test_profiling.py`` holds the
JAX package's: ``Metrics`` (``record``, ``timer``, ``summary``,
``dump_json``, ``reset``), beside the JAX one on the same series.  Its
spans and device stamps are held in ``tests/test_torch_spans.py``."""

import json
import time

import numpy as np

from sesameai_tts_tpu.utils import profiling as j_profiling
from sesameai_tts_tpu_torch.utils import profiling


def test_metrics_aggregation():
    m = profiling.Metrics()
    for v in [0.1, 0.2, 0.3]:
        m.record("stage", v)
    with m.timer("timed"):
        time.sleep(0.01)
    s = m.summary()
    assert s["stage"]["count"] == 3
    assert abs(s["stage"]["mean"] - 0.2) < 1e-9
    assert s["timed"]["count"] == 1 and s["timed"]["p50"] >= 0.01
    m.reset()
    assert m.summary() == {}


def test_timer_records_when_the_block_raises():
    m = profiling.Metrics()
    try:
        with m.timer("failing"):
            raise ValueError("boom")
    except ValueError:
        pass
    assert m.summary()["failing"]["count"] == 1


def test_summary_and_dump_json_match_the_jax_package():
    ours, theirs = profiling.Metrics(maxlen=8), j_profiling.Metrics(maxlen=8)
    vals = np.random.default_rng(0).uniform(size=20)
    for i, v in enumerate(vals):
        for m in (ours, theirs):
            m.record("a" if i % 3 else "b", float(v))
    assert ours.summary() == theirs.summary()
    assert json.loads(ours.dump_json()) == json.loads(theirs.dump_json())
    assert ours.dump_json() == theirs.dump_json()

