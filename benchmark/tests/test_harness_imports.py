"""Nothing the benchmark runs is JAX or the JAX package, compared by
whole top-level names (the port's name begins with the JAX package's)."""

import ast
import subprocess
import sys
import types

from benchmark.harness import check
from conftest import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "sesameai_tts_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_top_level_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "sesameai_tts_tpu_torch_x", types.ModuleType("a"))
    monkeypatch.setitem(sys.modules, "jaxtyping_x", types.ModuleType("b"))
    assert not [m for m in check.forbidden_modules() if m.endswith("_x")]
    monkeypatch.setitem(sys.modules, "sesameai_tts_tpu.ops_x", types.ModuleType("c"))
    monkeypatch.setitem(sys.modules, "jax.numpy_x", types.ModuleType("d"))
    assert {"sesameai_tts_tpu.ops_x", "jax.numpy_x"} <= set(check.forbidden_modules())


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        assert not [m for m in _imports(path) if m.startswith("sesameai")], path


def test_a_run_loads_no_jax(tiny_bench):
    """A whole tiny run in a fresh process, then the modules it loaded."""
    bench, bj = tiny_bench
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r});"
            "from pathlib import Path; from benchmark import run; from benchmark.harness import"
            " specs, check;"
            f"cell = specs.load_cell('tiny-narration', Path({str(bench)!r}), Path({str(bj)!r}));"
            "out = run.run_cell(cell, 3, 1.0, False, device='cpu');"
            "print(out['attempted'] > 0, check.forbidden_modules())")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "True []"


def test_run_without_a_card_prints_no_result():
    res = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                          "int8-chat-poisson", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    import torch

    if torch.cuda.is_available():
        return  # on a card the run is the benchmark itself
    assert res.returncode != 0 and res.stdout == ""
