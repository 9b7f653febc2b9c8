"""The readers of the program's spans and counters (`api_idle_ms.serve`,
`api_pad_waste_pct.serve`, `stream_dispatch_ms`, `train_update_ms`,
`train_data_wait_ms`) on a hand-made trace and recorder: their arithmetic,
and nothing where the spans are missing or the program has no recorder;
then a traced run of a serving cell on the CPU at a small size."""

import time

import pytest
import torch

from benchmark.harness import runner, spec
from benchmark.harness.trace import Trace
from benchmark.tests import bench_cells
from nsc_tpu_torch.utils import profiling

BASE_NS = 1_000 * 10**9  # the spans' host clock: trace seconds + 1000 s


def _span(name, start_s, end_s, *, parent=None, unit=0, ms=None, device_ms=None, clock=None):
    return {"name": name, "id": None, "parent": parent, "unit": unit,
            "start_ns": BASE_NS + round(start_s * 1e9), "end_ns": BASE_NS + round(end_s * 1e9),
            "ms": 1e3 * (end_s - start_s) if ms is None else ms, "self_ms": None,
            "device_ms": device_ms, "clock_ns": clock}


def _ctx(spans=(), counters=None, device=(), units=1, monkeypatch=None):
    """A reader's context over a trace of `device` intervals (seconds) and
    one `nsc.clock` event at 0.1 s, its stamp on the spans' clock."""
    host = [(0.0999, 0.1001, profiling.CLOCK)]
    tr = Trace(device=[(s, e, "k") for s, e in device], host=host)
    rec = {"spans": list(spans), "counters": counters or {}}
    monkeypatch.setattr(profiling, "recorded", lambda: rec)
    return {"trace": tr, "units": units, "busy_s": tr.busy_s(), "window_s": tr.wall_s()}


def _clock():
    return BASE_NS + round(0.1 * 1e9)


def _api_spans():
    """api.encode [0.5, 7.2] s: pad [0.9, 1.4], model [2.5, 5.5], to_host
    [6.0, 7.1]."""
    return [_span("api.encode", 0.5, 7.2, clock=_clock()),
            _span("api.encode.pad", 0.9, 1.4, parent=0),
            _span("api.encode.model", 2.5, 5.5, parent=0),
            _span("api.encode.to_host", 6.0, 7.1, parent=0)]


DEVICE = [(0.0, 1.0), (2.0, 3.0), (5.0, 6.0), (6.5, 7.0), (8.0, 9.0)]


def test_api_idle_counts_gaps_under_the_api_but_not_under_its_model(monkeypatch):
    """Gaps (1, 2) under api.encode's own time and (6, 6.5) under to_host
    count; (3, 5) under the model and (7, 8) outside the call do not:
    1.5 s over 3 batches."""
    read = spec.metric_reader("api_idle_ms.serve")
    ctx = _ctx(_api_spans(), device=DEVICE, units=3, monkeypatch=monkeypatch)
    assert read(ctx) == pytest.approx(500.0, rel=1e-6)


@pytest.mark.parametrize("case", ["no api spans", "no device work", "no clock"])
def test_api_idle_is_nothing_without_its_spans(monkeypatch, case):
    read = spec.metric_reader("api_idle_ms.serve")
    spans = _api_spans()
    if case == "no api spans":
        spans = [dict(s, name=s["name"].replace("api.", "stream.")) for s in spans]
    if case == "no clock":
        spans = [dict(s, clock_ns=None) for s in spans]
    ctx = _ctx(spans, device=() if case == "no device work" else DEVICE, monkeypatch=monkeypatch)
    assert read(ctx) is None


def test_pad_waste_is_the_share_of_frames_run_beyond_those_asked(monkeypatch):
    read = spec.metric_reader("api_pad_waste_pct.serve")
    ctx = _ctx(counters={"api.frames": 2 * 64 * 500, "api.frames_run": 2 * 64 * 512},
               monkeypatch=monkeypatch)
    assert read(ctx) == pytest.approx(2.4)
    assert read(_ctx(counters={"api.frames": 10, "api.frames_run": 10},
                     monkeypatch=monkeypatch)) == 0.0
    assert read(_ctx(monkeypatch=monkeypatch)) is None


def test_stream_dispatch_sums_the_model_spans_a_round(monkeypatch):
    read = spec.metric_reader("stream_dispatch_ms")
    spans = []
    for r in range(2):
        spans += [_span("stream.encode", 0, 1, unit=2 * r, ms=90.0),
                  _span("stream.encode.model", 0, 1, unit=2 * r, ms=30.0),
                  _span("stream.encode.to_host", 0, 1, unit=2 * r, ms=50.0),
                  _span("stream.decode.model", 0, 1, unit=2 * r + 1, ms=20.0)]
    assert read(_ctx(spans, units=2, monkeypatch=monkeypatch)) == pytest.approx(50.0)
    assert read(_ctx(spans[:1], units=2, monkeypatch=monkeypatch)) is None


def test_train_update_is_the_mean_device_time_of_its_span(monkeypatch):
    read = spec.metric_reader("train_update_ms")
    spans = [_span("train.update", 0, 1, device_ms=90.0), _span("train.step", 0, 1, device_ms=1e3),
             _span("train.update", 0, 1, device_ms=100.0)]
    assert read(_ctx(spans, units=2, monkeypatch=monkeypatch)) == pytest.approx(95.0)
    cpu = [dict(s, device_ms=None) for s in spans]
    assert read(_ctx(cpu, units=2, monkeypatch=monkeypatch)) is None
    assert read(_ctx(spans[1:2], monkeypatch=monkeypatch)) is None


def test_data_wait_is_host_time_a_step(monkeypatch):
    read = spec.metric_reader("train_data_wait_ms")
    spans = [_span("data.wait", 0, 1, ms=m) for m in (0.2, 0.4, 0.6)]
    spans.append(_span("train.step", 0, 1, ms=1000.0))
    assert read(_ctx(spans, units=3, monkeypatch=monkeypatch)) == pytest.approx(0.4)
    assert read(_ctx(spans[3:], units=3, monkeypatch=monkeypatch)) is None


@pytest.mark.parametrize("name", ["api_idle_ms.serve", "api_pad_waste_pct.serve",
                                  "stream_dispatch_ms", "train_update_ms",
                                  "train_data_wait_ms"])
def test_a_program_without_the_recorder_reads_nothing(monkeypatch, name):
    """The parent of these readers has no `recorded`: each returns None."""
    ctx = _ctx(_api_spans(), counters={"api.frames": 1, "api.frames_run": 2}, device=DEVICE,
               monkeypatch=monkeypatch)
    monkeypatch.delattr(profiling, "recorded")
    assert spec.metric_reader(name)(ctx) is None


def test_a_traced_serving_run_on_the_cpu_reports_the_counters():
    """The small base_fast cell traced on the CPU: 0.2 s clips are 10
    frames, run in the 64-frame bucket; no device work, so no idle."""
    profiling.clear()
    saved = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        cell = bench_cells.small_cell("serve.base_fast.b64x10s")
        res = runner.run(cell, 2147483901, 0.1, True, torch.device("cpu"), time.perf_counter())
    finally:
        torch.set_num_threads(saved)
        profiling.clear()
    assert res["correct"]
    assert res["metrics"]["api_pad_waste_pct.serve"]["value"] == pytest.approx(540.0)
    assert "api_idle_ms.serve" not in res["metrics"]
