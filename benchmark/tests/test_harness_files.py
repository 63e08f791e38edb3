"""A cell, a configuration, a model family, a traffic mix, a loop and a
metric are added as files of their own and found by name, with no file
edited."""

import json
import re

import pytest

from benchmark import run as bench_run
from benchmark.harness import specs

NEW_LOOP = '''"""All of a mix's requests at the window's start."""
import time
from benchmark.harness import texts
from benchmark.harness.client import Request


def plan(mix, rng, seconds, n_voices, config):
    n = mix["requests"]
    return [Request(text=texts.sized(config, i % n_voices, 6, 1, rng), voice=i % n_voices,
                    budget_ms=mix["audio_ms"], temperature=1.0, topk=1) for i in range(n)]


def drive(send, requests, t0, t1, ended):
    for r in requests:
        r.scheduled = time.perf_counter()
        send(r)
    return {"sent": len(requests)}
'''

NEW_METRIC = '''"""requests_sent: how many requests the loop sent."""


def read(run, name):
    return float(len(run.requests))
'''


def test_new_files_are_found_by_name(tiny_bench, tmp_path):
    bench, _ = tiny_bench
    cfg = json.loads((bench / "configs" / "csm-tiny-int8.json").read_text())
    cfg["quantize"] = "int4"
    (bench / "configs" / "csm-tiny-int4.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "burst.py").write_text(NEW_LOOP)
    (bench / "traffic" / "tiny-burst.json").write_text(json.dumps(
        {"loop": "burst", "requests": 3, "audio_ms": 480.0, "voices": 1, "voice_rows": [20, 20]}))
    (bench / "workloads" / "tiny-int4-burst.json").write_text(json.dumps(
        {"slots": 2, "chunk_frames": 4,
         "correct": {"logit_gap": 0.5, "topk_gap": 0.5, "pcm_err": 1e-3, "min_tokens": 16}}))
    (bench / "metrics" / "requests_sent.py").write_text(NEW_METRIC)
    (bench / "metrics" / "requests_sent.by_cell.py").write_text(NEW_METRIC)
    bj = tmp_path / "BENCHMARK.json"
    bj.write_text(json.dumps({
        "workloads": [{"name": "tiny-int4-burst", "config": "csm-tiny-int4",
                       "traffic": "tiny-burst", "chips": 1, "why": "test"}],
        "end_to_end": [{"name": "setup_s", "unit": "s"},
                       {"name": "requests_sent", "unit": "requests",
                        "workloads": ["tiny-int4-burst"]},
                       {"name": "chunk_gap_p95_ms", "unit": "ms", "workloads": ["another"]}],
        "per_layer": [{"name": "requests_sent.by_cell", "unit": "requests"},
                      {"name": "slot_use.tiny", "unit": "%"}]}))
    cell = specs.load_cell("tiny-int4-burst", bench, bj)
    assert cell.config["quantize"] == "int4" and cell.traffic["loop"] == "burst"
    assert [m.name for m in cell.end_to_end] == ["setup_s", "requests_sent"]
    assert specs.reader(bench, "slot_use.tiny").__doc__.startswith("slot_use")
    out = bench_run.run_cell(cell, 7, 1.0, False, device="cpu")
    run = out["run"]
    assert bench_run.metrics_of(run, False)["requests_sent"]["value"] == 3.0
    per_layer = bench_run.metrics_of(run, True)
    assert per_layer["requests_sent.by_cell"]["value"] == 3.0
    assert "slot_use.tiny" in per_layer
    assert out["ok"], out["check_lines"]


NEW_FAMILY = '''"""csm_twin: the csm family under another name, each call recorded."""
from pathlib import Path

from benchmark.harness import specs

_csm = specs.family(Path(__file__).resolve().parents[1], "csm")
calls = []


def _recorded(name):
    def call(*args, **kwargs):
        calls.append(name)
        return getattr(_csm, name)(*args, **kwargs)
    return call


for _name in ("draw", "port", "quantize", "reference", "quant_work", "attention_work",
              "prefill_attention_work", "frame_flops", "prefill_flops"):
    globals()[_name] = _recorded(_name)
'''


def _with_config(bench, tmp_path, model_type):
    """A configuration of ``model_type`` and a chat cell over it, added
    as files → the cell's BENCHMARK.json."""
    cfg = json.loads((bench / "configs" / "csm-tiny-int8.json").read_text())
    cfg["model_type"] = model_type
    (bench / "configs" / f"tiny-{model_type}.json").write_text(json.dumps(cfg))
    settings = (bench / "workloads" / "tiny-chat.json").read_text()
    (bench / "workloads" / f"tiny-{model_type}-chat.json").write_text(settings)
    bj = tmp_path / "BENCHMARK.json"
    bj.write_text(json.dumps({
        "workloads": [{"name": f"tiny-{model_type}-chat", "config": f"tiny-{model_type}",
                       "traffic": "tiny-chat", "chips": 1, "why": "test"}],
        "end_to_end": [{"name": "setup_s", "unit": "s"},
                       {"name": "chunk_gap_p95_ms", "unit": "ms"}],
        "per_layer": [{"name": "step_mfu.twin", "unit": "%"}]}))
    return bj


def test_a_model_family_is_found_by_model_type(tiny_bench, tmp_path):
    """The twin's draw, port, quantization and reference serve the run
    and its check, and its counts the per-layer readers."""
    bench, _ = tiny_bench
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    (bench / "families" / "csm_twin.py").write_text(NEW_FAMILY)
    bj = _with_config(bench, tmp_path, "csm_twin")
    cell = specs.load_cell("tiny-csm_twin-chat", bench, bj)
    out = bench_run.run_cell(cell, 2**31 + 7, 2.0, False, device="cpu")
    assert out["ok"], out["check_lines"]
    run = out["run"]
    run.device_name = "NVIDIA H100 80GB HBM3"  # a peak for the reader's arithmetic
    assert "step_mfu.twin" in bench_run.metrics_of(run, True)
    calls = cell.family.calls
    assert calls.count("draw") == 2  # the program's weights and the reference's
    assert {"port", "quantize", "reference"} <= set(calls)
    assert set(calls) & {"frame_flops", "prefill_flops"}
    assert all(p.read_bytes() == data for p, data in before.items())


def test_an_unknown_model_type_fails_at_load(tiny_bench, tmp_path):
    bench, _ = tiny_bench
    bj = _with_config(bench, tmp_path, "no_such_family")
    missing = bench / "families" / "no_such_family.py"
    with pytest.raises(SystemExit, match=re.escape(str(missing))):
        specs.load_cell("tiny-no_such_family-chat", bench, bj)
