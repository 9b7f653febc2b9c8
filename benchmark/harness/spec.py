"""`BENCHMARK.json` and the files it names, found by name: a cell's
configuration (`configs/<name>.json`, its path in the `configs` entry),
its traffic mix (`traffic/<traffic>.json`), its limits
(`limits/<workload>.json`) and the reader of each per-layer metric
(`metrics/<metric>.py`)."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


@dataclass
class Cell:
    """One workload of `BENCHMARK.json` with everything it names."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, dict]
    end_to_end: List[dict]
    per_layer: List[dict]


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def find_cell(bench: dict, workload: str, root: Path = ROOT) -> Cell:
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; have {sorted(cells)}")
    w = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(root / cfg_entry["file"]) as f:
        config = json.load(f)
    with open(BENCH_DIR / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    with open(BENCH_DIR / "limits" / f"{workload}.json") as f:
        limits = json.load(f)
    return Cell(
        name=workload, chips=w["chips"], config=config, traffic=traffic, limits=limits,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)],
    )


def metric_reader(name: str):
    """The `read(ctx)` function of `metrics/<name>.py`."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
