"""What the benchmark imports: nothing whose top-level name is `jax`,
`jaxlib`, `flax` or `nsc_tpu` (compared whole: `nsc_tpu_torch` begins with
`nsc_tpu`), and under `reference/` nothing of the port."""

import ast
import sys

import pytest

from benchmark import run
from benchmark.harness import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "nsc_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _files(sub=""):
    root = spec.BENCH_DIR / sub
    return sorted(p for p in root.rglob("*.py") if "_cache" not in p.parts)


def test_the_scan_finds_the_files():
    names = {p.name for p in _files()}
    assert {"run.py", "runner.py", "codec.py", "train.py", "mfu.serve.py"} <= names


@pytest.mark.parametrize("path", _files(), ids=lambda p: str(p.relative_to(spec.BENCH_DIR)))
def test_no_jax_or_the_jax_package(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & FORBIDDEN, tops & FORBIDDEN


@pytest.mark.parametrize("path", _files("reference"),
                         ids=lambda p: str(p.relative_to(spec.BENCH_DIR)))
def test_the_reference_imports_nothing_of_the_port(path):
    mods = set(_imports(path))
    assert not {m for m in mods if m.split(".")[0] == "nsc_tpu_torch"}
    # and nothing of the harness that drives the port
    assert not {m for m in mods if m.startswith("benchmark.") and not m.startswith("benchmark.reference")}


def test_the_run_names_what_it_forbids(monkeypatch):
    assert set(run.FORBIDDEN) == FORBIDDEN
    assert run.loaded_forbidden() == sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    monkeypatch.setitem(sys.modules, "nsc_tpu_torchlike", object())
    assert "jaxlib" in run.loaded_forbidden()
    assert "nsc_tpu" not in run.loaded_forbidden()


def test_the_port_alone_loads_no_jax():
    import subprocess

    code = ("import sys; sys.path.insert(0, '.'); import benchmark.harness.runner, "
            "benchmark.harness.offline, benchmark.harness.live, benchmark.harness.train, "
            "nsc_tpu_torch.api, nsc_tpu_torch.streaming, nsc_tpu_torch.train.train, "
            "nsc_tpu_torch.train.data; from benchmark import run; print(run.loaded_forbidden())")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=300, check=True).stdout.split()
    assert out[-1] == "[]"
