"""The port's tracing and timing helpers (`nsc_tpu_torch/utils/profiling.py`)
on the CPU: `timed` and `Stopwatch` keep nsc_tpu's names and keys,
`trace` writes a Chrome trace, and `summarize` reads device intervals
(here from hand-made events: the CPU has no device kernels)."""

import json
import time
import types

import torch

from nsc_tpu_torch.utils import profiling
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)


def test_timed_and_stopwatch_keys(capsys):
    out = {}
    with profiling.timed("step", out):
        time.sleep(0.01)
    assert set(out) == {"step"} and out["step"] >= 0.01
    with profiling.timed("printed"):
        pass
    assert "[timed] printed:" in capsys.readouterr().out
    sw = profiling.Stopwatch()
    for _ in range(3):
        with sw("data"):
            time.sleep(0.002)
    with sw("step"):
        pass
    rep = sw.report()
    assert set(rep) == {"time/data_ms", "time/step_ms"} and rep["time/data_ms"] >= 2.0


def test_barrier_is_a_no_op_on_the_cpu():
    profiling.barrier(torch.zeros(3))
    profiling.barrier("cpu")


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        x = torch.randn(64, 64)
        (x @ x).sum()
    path = tmp_path / "trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    assert any(ev.get("name") == "aten::mm" for ev in events)
    s = profiling.summarize(prof)
    assert s["top"] == [] and s["idle_share"] is None and s["kernel_launches"] == 0


class _Event:
    def __init__(self, name, device, start, end):
        self.name, self.device_type = name, f"DeviceType.{device}"
        self.time_range = types.SimpleNamespace(start=start, end=end)


class _Profile:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def test_summarize_reads_kernels_and_idle_share():
    """Two kernels overlap ([10, 30] and [20, 40] us), a copy at [60, 70],
    inside a host span [0, 100]: busy 40 of 100 us, idle share 0.6."""
    prof = _Profile([_Event("aten::conv1d", "CPU", 0, 100), _Event("k_a", "CUDA", 10, 30),
                     _Event("k_b", "CUDA", 20, 40), _Event("Memcpy DtoH", "CUDA", 60, 70)])
    s = profiling.summarize(prof, top=2)
    assert [t["name"] for t in s["top"]] == ["k_a", "k_b"]
    assert s["kernel_launches"] == 3 and abs(s["kernel_ms"] - 0.05) < 1e-12
    assert abs(s["wall_ms"] - 0.1) < 1e-12 and abs(s["busy_ms"] - 0.04) < 1e-12
    assert abs(s["idle_share"] - 0.6) < 1e-9
