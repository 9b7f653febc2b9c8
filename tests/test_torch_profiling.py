"""The port's tracing helpers (`nsc_tpu_torch/utils/profiling.py`) on the
CPU: `trace` writes a Chrome trace and the spans, `summarize` reads device
intervals (here from hand-made events: the CPU has no device kernels), and
the span recorder is off without a profiler, nests, counts and shares the
trace's clock; the API, streaming, train-step and data spans the program
records."""

import dataclasses
import json
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from nsc_tpu_torch import api, streaming, weights
from nsc_tpu_torch.configs import TrainConfig, get_config
from nsc_tpu_torch.train import data as data_lib
from nsc_tpu_torch.train import train as T
from nsc_tpu_torch.utils import profiling
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)


@pytest.fixture(autouse=True)
def _empty_recorder():
    profiling.clear()
    yield
    profiling.clear()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _names(rec):
    return [s["name"] for s in rec["spans"]]


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
    assert json.loads((tmp_path / "spans.json").read_text()) == {"traceEvents": [], "counters": {}}


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


def test_span_is_the_shared_null_without_a_profiler():
    a, b = profiling.span("x"), profiling.span("y")
    assert a is b
    with a as entered:
        profiling.count("n", 3)
    assert entered is None
    assert profiling.recorded() == {"spans": [], "counters": {}}


def test_spans_nest_under_a_profiler_with_parents_and_a_unit_each():
    with _cpu_profile():
        for _ in range(2):
            with profiling.span("outer"):
                with profiling.span("outer.a"):
                    with profiling.span("outer.a.inner"):
                        pass
                with profiling.span("outer.b"):
                    pass
    rec = profiling.recorded()
    spans = rec["spans"]
    assert _names(rec) == ["outer", "outer.a", "outer.a.inner", "outer.b"] * 2
    by_id = {s["id"]: s for s in spans}
    for s in spans:
        parent = by_id.get(s["parent"])
        assert (parent["name"] if parent else None) == (s["name"].rpartition(".")[0] or None)
        assert s["start_ns"] <= s["end_ns"] and s["device_ms"] is None
        assert (s["clock_ns"] is not None) == (parent is None)
    assert [s["unit"] for s in spans] == [0] * 4 + [1] * 4
    outer, a, inner, b = spans[:4]
    assert outer["self_ms"] == pytest.approx(outer["ms"] - a["ms"] - b["ms"], abs=1e-9)
    assert a["self_ms"] == pytest.approx(a["ms"] - inner["ms"], abs=1e-9)
    assert inner["self_ms"] == inner["ms"]


def test_clock_puts_the_spans_on_the_trace_within_a_millisecond():
    """Each top-level span leaves one `nsc.clock` host event; mapped by
    them, a span's host stamps enclose the ops run inside it."""
    x = torch.randn(256, 256)
    with _cpu_profile() as prof:
        for _ in range(3):
            with profiling.span("mm"):
                (x @ x).sum()
    host = [(ev.time_range.start / 1e6, ev.time_range.end / 1e6, ev.name) for ev in prof.events()]
    assert sum(n == profiling.CLOCK for _, _, n in host) == 3
    spans = profiling.on_trace(profiling.recorded()["spans"], host)
    mms = sorted((s, e) for s, e, n in host if n == "aten::mm")
    assert len(spans) == len(mms) == 3
    for sp, (s, e) in zip(spans, mms):
        assert sp["start_s"] <= s + 1e-3 and sp["end_s"] >= e - 1e-3
        assert e - s < sp["end_s"] - sp["start_s"] + 2e-3
    assert profiling.on_trace(profiling.recorded()["spans"], []) is None


def test_counters_add_up_under_a_profiler_only():
    profiling.count("frames", 5)
    with _cpu_profile():
        profiling.count("frames", 2)
        profiling.count("frames", 3)
        profiling.count("runs")
    assert profiling.recorded()["counters"] == {"frames": 5, "runs": 1}


def _bundle(causal):
    cfg = dataclasses.replace(get_config("tiny_test"), causal=causal)
    return api.bundle_from_jax(cfg, *weights.init_jax_layout(cfg, 0), device="cpu")


API = [f"api.{op}{part}" for op in ("encode", "decode")
       for part in ("", ".pad", ".to_device", ".model", ".to_host")]


@pytest.mark.parametrize("causal,frames,run", [(True, 500, 512), (False, 500, 500)])
def test_api_records_its_spans_and_the_bucket_waste(causal, frames, run):
    """A causal bundle runs 500 frames in the 512-frame bucket; a
    non-causal one pads to the hop only."""
    b = _bundle(causal)
    wav = np.random.RandomState(0).randn(3, frames * b.cfg.hop).astype(np.float32) * 0.1
    with _cpu_profile():
        idx = api.encode(b, wav)
        out = api.decode(b, idx)
    assert idx.shape[:2] == (3, frames) and out.shape == wav.shape
    rec = profiling.recorded()
    assert sorted(_names(rec)) == sorted(API)
    assert {s["unit"] for s in rec["spans"] if s["name"].startswith("api.encode")} == {0}
    assert {s["unit"] for s in rec["spans"] if s["name"].startswith("api.decode")} == {1}
    assert rec["counters"] == {"api.frames": 2 * 3 * frames, "api.frames_run": 2 * 3 * run}


def test_streaming_push_records_its_spans():
    b = api.load_model("tiny_test", device="cpu")
    enc = streaming.StreamingEncoder(b.model, b.params, b.rvq)
    dec = streaming.StreamingDecoder(b.model, b.params, b.rvq)
    chunk = np.zeros((2, 8 * b.cfg.hop), np.float32)
    with _cpu_profile():
        dec.push(enc.push(chunk))
    names = [f"stream.{op}{part}" for op in ("encode", "decode")
             for part in ("", ".to_device", ".model", ".to_host")]
    assert _names(profiling.recorded()) == names


def test_train_step_and_prefetcher_record_their_spans_and_keep_the_marks():
    tcfg = dataclasses.replace(TrainConfig(), batch_size=2, segment_seconds=0.2,
                               disc_width_mult=1 / 16, stft_fft_sizes=(512, 256, 128),
                               mel_fft_size=512, mel_bins=40)
    cfg = get_config("tiny_test")
    model, state = T.init_train_state(cfg, tcfg, torch.device("cpu"))
    src = data_lib.make_source("synthetic", cfg.sample_rate, 0)
    feed = data_lib.Prefetcher(src.batches(2, 3200), depth=1)
    marks = []
    try:
        with _cpu_profile():
            batch = torch.from_numpy(next(feed))
            T.make_train_step(model, tcfg)(state, batch, mark=marks.append)
    finally:
        feed.close()
    assert marks == ["generator", "discriminator", "updates"]
    rec = profiling.recorded()
    assert _names(rec) == ["data.wait", "train.step", "train.generator",
                           "train.discriminator", "train.update"]
    step = rec["spans"][1]
    assert all(s["parent"] == step["id"] for s in rec["spans"][2:])
    assert rec["spans"][0]["unit"] != step["unit"]


def test_trace_writes_the_spans_and_counters_on_its_clock(tmp_path):
    """`trace` clears what an earlier profiler left, then writes the
    window's spans as events on trace.json's clock beside its counters."""
    with _cpu_profile():
        with profiling.span("left.over"):
            pass
    with profiling.trace(str(tmp_path)):
        with profiling.span("work"):
            with profiling.span("work.mm"):
                torch.randn(128, 128).sum()
        profiling.count("rows", 4)
    out = json.loads((tmp_path / "spans.json").read_text())
    assert out["counters"] == {"rows": 4}
    assert [e["name"] for e in out["traceEvents"]] == ["work", "work.mm"]
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    randn = [e for e in events if e.get("name") == "aten::randn"][0]
    mm = out["traceEvents"][1]
    assert mm["ts"] <= randn["ts"] + 1e3 and mm["ts"] + mm["dur"] >= randn["ts"] + randn["dur"] - 1e3
    assert mm["args"]["parent"] == out["traceEvents"][0]["args"]["id"]
