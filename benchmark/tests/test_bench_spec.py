"""`BENCHMARK.json` against the benchmark's contract, and every file a cell
names found by name."""

import json
import re

import pytest

from benchmark.harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark()


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "benchmark/run.py"]
    assert bench["paths"] == ["benchmark"]
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) <= 64 * 1024


def test_names_and_units(bench):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
                assert e["source"] in SOURCES
    for group in ("configs", "workloads"):
        ns = [e["name"] for e in bench[group]]
        assert len(ns) == len(set(ns))
    metrics = [e["name"] for e in bench["end_to_end"] + bench["per_layer"]]
    assert len(metrics) == len(set(metrics))
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"] and "\t" not in w["why"]
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_entry_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert len(c["reduced"]) <= 16
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


def test_every_cell_reports_what_it_must(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] == 0.25
    for w in bench["workloads"]:
        cell = spec.find_cell(bench, w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in names, (w["name"], m["name"])


def test_files_found_by_name(bench):
    configs = {c["name"] for c in bench["configs"]}
    used = {w["config"] for w in bench["workloads"]}
    assert configs == used
    for w in bench["workloads"]:
        cell = spec.find_cell(bench, w["name"])
        assert cell.traffic["kind"] in ("offline", "live", "train")
        assert cell.limits and all("limit" in v for v in cell.limits.values())
        for m in cell.per_layer:
            assert callable(spec.metric_reader(m["name"]))
    for m in bench["per_layer"]:
        assert (spec.BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()


def test_configuration_files_are_what_runs(bench):
    from benchmark.harness import common

    for c in bench["configs"]:
        with open(spec.ROOT / c["file"]) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"] == []
        common.port_config(cfg, "serving")
        common.port_config(cfg, "training")
