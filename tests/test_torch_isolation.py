"""The port stands alone: nothing under nsc_tpu_torch/, and not
chip_smoke.py, the port's scripts (scripts/torch_*.py but the export
script, which reads the JAX package's checkpoints) or the data-parallel
test worker, imports JAX or the JAX package; entry points never move to the
CPU silently; the CPU paths launch no kernel and build nothing; a wheel
ships the CUDA sources the kernels build from."""

import ast
import os

import pytest
import torch

from nsc_tpu_torch import api, kernels
from nsc_tpu_torch.kernels import _build
from nsc_tpu_torch.kernels import residual_stack as RS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FORBIDDEN = {"jax", "jaxlib", "nsc_tpu"}


PORT_SCRIPTS = ("torch_write_gpu_pin.py", "torch_refit_flips.py", "torch_rvq_bench.py",
                "torch_k4_bench.py", "torch_tree_bench.py", "torch_k4_gradient.py",
                "torch_refit_flagship.py", "torch_finetune_flagship.py", "torch_rd_ceiling.py",
                "torch_harvest_checkpoints.py", "torch_heldout_trend.py",
                "torch_pick_export_step.py", "torch_export_flagship.py",
                "torch_train_watchdog.py")
PORT_SHELL_SCRIPTS = ("torch_close_flagship.sh", "torch_round_close.sh")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py"), os.path.join(ROOT, "tests", "torch_dp_worker.py")]
    out += [os.path.join(ROOT, "scripts", name) for name in PORT_SCRIPTS]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "nsc_tpu_torch")):
        out += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module":
            for arg in node.args[:1]:
                if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                    yield arg.value.split(".")[0]


def test_port_imports_no_jax_and_no_jax_package():
    files = _port_files()
    assert len(files) > 10 and all(os.path.exists(f) for f in files)
    names = {os.path.relpath(f, ROOT) for f in files}
    for module in ("parallel/mesh.py", "eval/sweep.py", "eval/__main__.py", "native.py",
                   "compat/torch_compat.py", "eval/heldout.py", "train/harvest.py",
                   "train/export.py", "train/watchdog.py"):
        assert f"nsc_tpu_torch/{module}" in names
    bad = {
        os.path.relpath(f, ROOT): sorted(set(_imported_roots(f)) & _FORBIDDEN)
        for f in files
    }
    assert {f: b for f, b in bad.items() if b} == {}


def test_every_port_script_is_scanned():
    """Each scripts/torch_* file is in PORT_SCRIPTS or PORT_SHELL_SCRIPTS."""
    names = {n for n in os.listdir(os.path.join(ROOT, "scripts")) if n.startswith("torch_")}
    assert names == set(PORT_SCRIPTS) | set(PORT_SHELL_SCRIPTS)


@pytest.mark.parametrize("name", PORT_SHELL_SCRIPTS)
def test_port_shell_scripts_stay_on_the_port(name):
    """Each port shell script parses (`bash -n`), names no module of the JAX
    package (only nsc_tpu_torch) and runs no script outside scripts/torch_*."""
    import re
    import subprocess

    path = os.path.join(ROOT, "scripts", name)
    assert subprocess.run(["bash", "-n", path], capture_output=True, timeout=30).returncode == 0
    text = open(path).read()
    assert re.findall(r"\bnsc_tpu\b(?!_torch)", text) == []
    assert [s for s in re.findall(r"scripts/[\w.]+", text)
            if not s.startswith("scripts/torch_")] == []
    assert "scripts/torch_" in text


def test_load_model_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.load_model("tiny_test")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.load_model("tiny_test", device="cuda")
    assert api.load_model("tiny_test", device="cpu").device.type == "cpu"


def test_cpu_serving_path_launches_no_kernel_and_builds_nothing(monkeypatch):
    def no_build():
        raise AssertionError("the CPU path asked for the CUDA library")

    monkeypatch.setattr(_build, "library", no_build)
    kernels.reset_launches()
    bundle = api.load_model("tiny_test", serving=True, device="cpu")
    assert bundle.model.kernels.units == "residual_stack" and bundle.model.kernels.rvq
    wav = torch.randn(2, 40 * bundle.cfg.hop).numpy() * 0.1
    idx = api.encode(bundle, wav)
    out = api.decode(bundle, idx)
    assert out.shape == (2, 40 * bundle.cfg.hop)
    assert kernels.LAUNCHES == {
        "residual_stack": 0, "rvq_quantize": 0, "rvq_split_planes": 0, "rvq_dequantize": 0,
        "stft_magnitude": 0, "stft_magnitude_bluestein": 0,
        "stft_magnitude_bluestein_cluster": 0, "stft_magnitude_bluestein_global": 0,
        "residual_stack_cl": 0, "fused_stage": 0, "int_mm": 0,
    }


def test_wrappers_refuse_other_devices():
    x = torch.empty(1, 8, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        RS.residual_stack(x, {}, (1,), True)


def test_chip_smoke_without_cuda_fails_and_prints_no_result(tmp_path):
    """Without a card the script exits non-zero and prints nothing on
    stdout (no result line). Run in a directory holding only the script."""
    import shutil
    import subprocess
    import sys

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    script = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), script)
    proc = subprocess.run(
        [sys.executable, str(script)], cwd=tmp_path, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert proc.stdout == ""


def test_wheel_ships_the_cuda_sources_and_the_torch_extra():
    import glob
    import tomllib

    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        proj = tomllib.load(f)
    assert set(proj["project"]["optional-dependencies"]["torch"]) >= {"torch", "numpy", "scipy",
                                                                      "einops"}
    patterns = proj["tool"]["setuptools"]["package-data"]["nsc_tpu_torch"]
    pkg = os.path.join(ROOT, "nsc_tpu_torch")
    shipped = {p for pat in patterns for p in glob.glob(os.path.join(pkg, pat))}
    needed = {os.path.join(_build.CSRC, n) for n in os.listdir(_build.CSRC)}
    assert needed and needed <= shipped
    assert {os.path.basename(p) for p in needed} >= set(_build.SOURCES)
    assert any(p.endswith(".cuh") for p in needed)
