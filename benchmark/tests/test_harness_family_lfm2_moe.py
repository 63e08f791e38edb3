"""The model family ``lfm2_moe`` (``families/lfm2_moe.py``) as files of its
own: its tiny cell (``tests/tiny/configs/lfm2-tiny-int8.json``, the port's
test-tiny-hybrid backbone) runs correct through the harness in a copy of
the benchmark's folder, and each control of the cell's comparison comes
out not correct there: a reference at 4 bits, an fp8 Mimi, the sampler's
top-k left out, the conv state dropped at every decode step and the
expert bias left out of the choice (the last two options of the family's
reference, judged against the reference itself), and the program run with
each planted fault of ``controls.py`` (a routed product dropped in the
expert kernel, the routing weights not normalised).  The new reader
``moe_matmul_roofline`` reads a number from synthetic ticks and a
synthetic trace, and nothing where there is nothing to read; the work
counts are the published shapes'."""

import json
from types import SimpleNamespace

import pytest
import torch

from benchmark import calibrate, controls
from benchmark import run as bench_run
from benchmark.harness import check, specs, trace
from conftest import BENCH

CELL = "tiny-lfm2-narration"
SEED = 2**31 + 11


def _bench_json(tmp_path):
    bj = tmp_path / "BENCHMARK.json"
    bj.write_text(json.dumps({
        "workloads": [{"name": CELL, "config": "lfm2-tiny-int8", "traffic": "tiny-narration",
                       "chips": 1, "why": "test"}],
        "end_to_end": [{"name": "setup_s", "unit": "s"},
                       {"name": "chunk_gap_p95_ms", "unit": "ms"}],
        "per_layer": [{"name": "moe_matmul_roofline", "unit": "%"},
                      {"name": "quant_matmul_roofline.lfm2", "unit": "%"},
                      {"name": "backbone_step_ms.lfm2", "unit": "ms"},
                      {"name": "step_mfu.lfm2", "unit": "%"}]}))
    return bj


@pytest.fixture
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def cell(tiny_bench, tmp_path):
    bench, _ = tiny_bench
    return specs.load_cell(CELL, bench, _bench_json(tmp_path))


def test_the_tiny_cell_is_correct_and_its_controls_are_not(cell, one_thread):
    out = bench_run.run_cell(cell, SEED, 2.0, False, device="cpu", control=True)
    assert out["ok"], out["check_lines"]
    assert out["controls"] == {"tokens": False, "pcm": False}, out["readings"]
    run = out["run"]
    run.device_name = "NVIDIA H100 80GB HBM3"  # a peak for the reader's arithmetic
    assert bench_run.metrics_of(run, True)["step_mfu.lfm2"]["value"] > 0
    finished = [r for r in run.requests if r.ended is not None and r.error is None
                and not r.cancelled]
    gaps = controls.option_gaps(cell, SEED, "cpu", run.voices, finished,
                                {"conv_reset": {"conv_reset": True},
                                 "no_bias": {"expert_bias": False}})
    limits = cell.settings["correct"]
    for name, gap in gaps.items():
        ok, _ = check.verdict(dict(out["readings"], logit_gap=gap), limits,
                              int(limits["min_tokens"]))
        assert not ok, (name, gap, limits)


def test_the_tiny_cell_with_top_k_left_out_is_not_correct(cell, one_thread):
    out = bench_run.run_cell(cell, SEED, 2.0, False, device="cpu",
                             fault=calibrate.FAULTS["topk-off"])
    assert not out["ok"]
    assert out["readings"]["topk_gap"] > cell.settings["correct"]["topk_gap"]


@pytest.mark.parametrize("fault", sorted(controls.FAULTS))
def test_each_planted_fault_of_the_program_is_not_correct(cell, one_thread, fault):
    got = controls.fault_run(cell, SEED, 2.0, fault, device="cpu")
    assert not got["correct"], got
    assert got["logit_gap"] > cell.settings["correct"]["logit_gap"], got


def test_the_routing_of_program_and_reference_mostly_agree(cell, one_thread):
    out = bench_run.run_cell(cell, SEED, 2.0, False, device="cpu")
    run = out["run"]
    greedy = controls._greedy([r for r in run.requests if r.ended is not None], 8)
    got = controls.routing_differs(cell, SEED, "cpu", run.voices, greedy[0])
    assert got["routing_pairs"] > 0 and 0.0 <= got["routing_differs"] < 0.25, got


def _tick(tid, t0, hit, n=2):
    b = [t0 + 0.03 * i for i in range(n)]
    loop = t0 + 0.03 * n
    stamps = {"backbone": b, "sample": [x + 0.01 for x in b], "loop": [loop],
              "mimi": [loop + 0.005], "fetch": [loop + 0.006]}
    return SimpleNamespace(id=tid, n=n, live=(1,), stamps=stamps, experts_hit=hit,
                           launch=SimpleNamespace(start=t0 - 0.005, end=t0 - 0.004))


def test_the_moe_roofline_reader_reads_synthetic_ticks_and_a_trace():
    cfg = json.loads((BENCH / "configs" / "csm-lfm2-8b-a1b-int8.json").read_text())
    family = specs.family(BENCH, "lfm2_moe")
    ticks = [_tick(i, 1.0 + 0.2 * i, hit=2 * 600) for i in range(1, 4)]  # 600 a frame-step
    records = [trace.Kernel("void (anonymous namespace)::expert_up_kernel<16>(...)", 0.0, 1e-3),
               trace.Kernel("void (anonymous namespace)::expert_down_kernel<16>(...)", 1e-3,
                            1.5e-3),
               trace.Kernel("expert_sum_kernel(...)", 1.5e-3, 1.6e-3),
               trace.Kernel("qmm_mma_kernel", 1.6e-3, 2e-3)]
    tr = trace.Trace(records, 0.0, 1.0, 0.0,
                     [trace.HostCall("tick", 0.1, 0.2, 3, ())])
    run = SimpleNamespace(requests=[SimpleNamespace(session=SimpleNamespace(ticks=ticks))],
                          t0=0.0, t1=10.0 + trace.TRACE_S, trace=tr, config=cfg, slots=16,
                          device_name="NVIDIA H100 80GB HBM3",
                          cell=SimpleNamespace(family=family))
    reader = specs.reader(BENCH, "moe_matmul_roofline")
    nbytes, _ = family.moe_work(cfg, 600, 16)
    want = 100.0 * 3 * (nbytes / 3.35e12) / 1.6e-3
    assert reader.read(run, "moe_matmul_roofline") == pytest.approx(want)
    for t in ticks:  # a program without the counter
        t.experts_hit = None
    assert reader.read(run, "moe_matmul_roofline") is None
    run.cell = SimpleNamespace(family=specs.family(BENCH, "csm"))  # a family without experts
    assert reader.read(run, "moe_matmul_roofline") is None


def test_the_work_counts_at_the_published_shapes():
    cfg = json.loads((BENCH / "configs" / "csm-lfm2-8b-a1b-int8.json").read_text())
    fam = specs.family(BENCH, "lfm2_moe")
    D, Fe = 2048, 1792
    # one hit expert is 11.0 MB of int8 weights and 28 KB of scales
    nbytes, flops = fam.moe_work(cfg, 1, 0)
    assert nbytes == 3 * D * Fe + 4 * (2 * Fe + D) and flops == 0
    # active: 1.5 B of the backbone's 8.3 B, as LiquidAI gives them
    assert 1.2e9 < fam.active_params(cfg) < 1.6e9
    dense_b, _ = fam.quant_work(cfg, 16, 8, 1, "backbone")
    assert 0.4e9 < dense_b < 0.5e9  # the backbone's dense int8 products: ~0.45 GB
    b, f = fam.attention_work(cfg, [600], "backbone")
    assert b == 6 * 2.0 * (2 * 8 * 600 * 64 + 2 * 32 * 64) and f == 6 * 4.0 * 32 * 64 * 600
    assert fam.frame_flops(cfg, 400) > 2 * fam.active_params(cfg)
