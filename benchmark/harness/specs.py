"""The benchmark's data files, found by name.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``: a configuration
(``configs/<config>.json``, whose ``model_type`` names its model family
``families/<model_type>.py``), a traffic mix (``traffic/<traffic>.json``,
whose ``loop`` names its generator ``traffic/<loop>.py``) and the cell's
own settings (``workloads/<cell>.json``: the pool and the limits of the
comparison).  A metric is an entry of
``end_to_end`` or ``per_layer``; its reader is ``metrics/<name>.py``, or
``metrics/<base>.py`` for a name ``<base>.<suffix>``.  Adding a cell, a
configuration, a model family, a mix, a loop or a metric adds files and
edits none.

A model family is everything model-shaped that the harness needs: the
weights (``draw``), the port's configurations (``port``), the program's
quantization (``quantize``), the plain reference (``reference``) and the
per-layer readers' work counts (README, "A model family").
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
REPO_ROOT = BENCH_DIR.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """The Python file ``path`` as a module of its own (its name may hold
    dots and dashes, so it is loaded by path, not imported)."""
    spec = importlib.util.spec_from_file_location(f"benchmark_{name}".replace("-", "_")
                                                  .replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Metric:
    name: str
    unit: str


@dataclass
class Cell:
    name: str
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    settings: dict
    chips: int
    end_to_end: List[Metric]
    per_layer: List[Metric]
    bench_dir: Path
    family: ModuleType

    def loop(self):
        """The traffic mix's generator module (``traffic/<loop>.py``)."""
        loop = self.traffic["loop"]
        return load_module(self.bench_dir / "traffic" / f"{loop}.py", f"loop_{loop}")


def family(bench_dir: Path, model_type: Optional[str]) -> ModuleType:
    """The model family ``families/<model_type>.py`` under ``bench_dir``."""
    path = bench_dir / "families" / f"{model_type}.py"
    if model_type is None or not path.exists():
        raise SystemExit(f"no model family for model_type {model_type!r}: {path} is missing")
    return load_module(path, f"family_{model_type}")


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(name: str, bench_dir: Path = BENCH_DIR,
              benchmark_json: Optional[Path] = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with everything it names."""
    bench = load_json(benchmark_json or bench_dir.parent / "BENCHMARK.json")
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = entries[0]
    settings_path = bench_dir / "workloads" / f"{name}.json"
    metrics = {}
    for kind in ("end_to_end", "per_layer"):
        metrics[kind] = [Metric(m["name"], m["unit"]) for m in bench[kind] if _applies(m, name)]
    config = load_json(bench_dir / "configs" / f"{w['config']}.json")
    return Cell(
        name=name,
        config_name=w["config"],
        config=config,
        traffic_name=w["traffic"],
        traffic=load_json(bench_dir / "traffic" / f"{w['traffic']}.json"),
        settings=load_json(settings_path),
        chips=int(w["chips"]),
        end_to_end=metrics["end_to_end"],
        per_layer=metrics["per_layer"],
        bench_dir=bench_dir,
        family=family(bench_dir, config.get("model_type")),
    )


def reader(bench_dir: Path, metric: str):
    """The reader of ``metric``: ``metrics/<metric>.py``, else the reader of
    its base name (the part before the first dot)."""
    path = bench_dir / "metrics" / f"{metric}.py"
    if not path.exists():
        path = bench_dir / "metrics" / f"{metric.split('.')[0]}.py"
    if not path.exists():
        raise SystemExit(f"no reader for metric {metric!r} under {bench_dir / 'metrics'}")
    return load_module(path, f"metric_{metric}")
