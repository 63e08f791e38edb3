"""The benchmark's CPU tests: ``python -m pytest benchmark/tests -q``
from the repository's root (tests marked ``gpu`` skip without a card)."""

import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

BENCH = ROOT / "benchmark"
TINY = BENCH / "tests" / "tiny"


@pytest.fixture
def tiny_bench(tmp_path):
    """A benchmark folder of the tiny CPU cells: the real model families,
    loops, readers and word list, and the tiny configuration, mixes and
    cells beside them → (folder, its BENCHMARK.json)."""
    bench = tmp_path / "benchmark"
    for d in ("families", "traffic", "metrics"):
        shutil.copytree(BENCH / d, bench / d)
    for d in ("configs", "traffic", "workloads"):
        (bench / d).mkdir(exist_ok=True)
        for f in (TINY / d).iterdir():
            shutil.copy(f, bench / d / f.name)
    return bench, TINY / "BENCHMARK.json"
