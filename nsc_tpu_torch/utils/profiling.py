"""Tracing (counterpart of `nsc_tpu/utils/profiling.py`).

  * `trace(dir)`: `torch.profiler.profile` over CPU and CUDA activities,
    writing a Chrome trace (`trace.json`, open in chrome://tracing or
    Perfetto) and the program's spans and counters (`spans.json`) into
    `dir`; the profiler object is yielded, for `summarize`.
  * `summarize(prof)`: the traced window's device kernels by self time
    (top N) and its idle share: wall minus the union of the kernel
    intervals, over wall.
  * `span(name)`, `count(name, n)`: the program's own spans and counters,
    recorded while a torch profiler runs and free (one shared null context)
    while none does. `recorded()` gives them, `on_trace` puts the spans on
    a trace's clock.

A span records its name, its parent (a stack per thread), a unit id that
every span under one top-level span shares, its host start and end
(`time.time_ns()`) and, where CUDA is initialised, two timing events on the
current stream whose elapsed time (`device_ms`) is read once the caller has
synchronised. Spans stay in this module's memory: none enters
`record_function`, since a profiled `record_function` that encloses kernel
launches also gets a CUDA-typed user annotation, which a reader of the
trace would count as device work. The one profiler event the recorder adds
is an empty `record_function` named `nsc.clock` at each top-level span,
with a `time.time_ns()` stamp taken inside it: a host event that ties the
spans' stamps to the trace's timebase.

`barrier(x)` synchronizes the CUDA device of `x` (or the current one when
`x` is None and CUDA is there); on the CPU it does nothing.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import statistics
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional

import torch

CLOCK = "nsc.clock"

# the profiler's own flag: true on a thread while a torch profiler records it
_profiling = torch._C._autograd._profiler_enabled


def barrier(x=None) -> None:
    """Wait for the device work queued before it: `torch.cuda.synchronize`
    of x's device (a tensor, or a device), or of the current CUDA device
    when x is None; nothing on the CPU."""
    if isinstance(x, torch.Tensor):
        dev = x.device
    elif x is None:
        dev = torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu")
    else:
        dev = torch.device(x)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# ---------------------------------------------------------------------------
# spans and counters
# ---------------------------------------------------------------------------


class _Null:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def _clock_ns() -> int:
    with torch.profiler.record_function(CLOCK):
        return time.time_ns()


class _Span:
    __slots__ = ("rec", "name", "id", "parent", "unit", "clock_ns", "start_ns", "end_ns",
                 "events", "device_ms")

    def __init__(self, rec: "Recorder", name: str):
        self.rec, self.name = rec, name
        self.clock_ns = self.end_ns = self.events = self.device_ms = None

    def __enter__(self):
        rec = self.rec
        stack = rec._stack()
        if stack:
            self.parent, self.unit = stack[-1].id, stack[-1].unit
        else:
            self.parent, self.unit = None, next(rec._units)
            self.clock_ns = _clock_ns()
        self.id = next(rec._ids)
        stack.append(self)
        rec._spans.append(self)
        if torch.cuda.is_initialized():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        if self.events is not None:
            self.events[1].record()
        self.rec._stack().pop()
        return False

    def _device_ms(self) -> Optional[float]:
        if self.events is not None:
            self.events[1].synchronize()
            self.device_ms = self.events[0].elapsed_time(self.events[1])
            self.events = None
        return self.device_ms


class Recorder:
    """The spans and counters of a process while a torch profiler runs.

    Only `clear` (and `trace`, which calls it) empties it: under profilers
    that do not clear it, the spans of every profiled window gather here,
    each holding its two CUDA events."""

    def __init__(self):
        self._local = threading.local()
        self._lock = threading.Lock()
        self.clear()

    def clear(self) -> None:
        self._spans: List[_Span] = []
        self._counters: Dict[str, int] = defaultdict(int)
        self._units = itertools.count()
        self._ids = itertools.count()

    def _stack(self) -> List[_Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str):
        """A context manager: a span of `name` while a profiler records this
        thread, else the shared null context."""
        if not _profiling():
            return _NULL
        return _Span(self, name)

    def count(self, name: str, n: int = 1) -> None:
        """Add `n` to counter `name` while a profiler records this thread."""
        if _profiling():
            with self._lock:
                self._counters[name] += n

    def recorded(self) -> dict:
        """{"spans": closed spans in the order they opened, "counters":
        {name: total}}. A span is a dict: name, id, parent (its parent's id
        or None), unit, start_ns and end_ns (`time.time_ns()`), ms, self_ms
        (ms less its children's), device_ms (None off CUDA; waits for the
        span's end event) and clock_ns (the `nsc.clock` stamp of a
        top-level span, else None)."""
        spans = [s for s in list(self._spans) if s.end_ns is not None]
        child_ns: Dict[int, int] = defaultdict(int)
        for s in spans:
            if s.parent is not None:
                child_ns[s.parent] += s.end_ns - s.start_ns
        out = [{"name": s.name, "id": s.id, "parent": s.parent, "unit": s.unit,
                "start_ns": s.start_ns, "end_ns": s.end_ns, "ms": (s.end_ns - s.start_ns) / 1e6,
                "self_ms": (s.end_ns - s.start_ns - child_ns[s.id]) / 1e6,
                "device_ms": s._device_ms(), "clock_ns": s.clock_ns} for s in spans]
        with self._lock:
            counters = dict(self._counters)
        return {"spans": out, "counters": counters}


RECORDER = Recorder()


def span(name: str):
    """A span of the process-wide recorder (see `Recorder.span`)."""
    return RECORDER.span(name)


def count(name: str, n: int = 1) -> None:
    RECORDER.count(name, n)


def recorded() -> dict:
    return RECORDER.recorded()


def clear() -> None:
    RECORDER.clear()


def on_trace(spans: List[dict], host) -> Optional[List[dict]]:
    """`spans` (as `recorded` gives them) on a trace's clock: each gains
    "start_s" and "end_s" in the seconds of `host`, the trace's host events
    as (start_s, end_s, name). The `nsc.clock` events among them, in time
    order, pair with the top-level spans' stamps, the last k of each (k the
    fewer: a recorder that outlived an earlier profiler holds older stamps
    first); the offset is the median over the pairs of the event's middle
    less its stamp. None where there is nothing to pair."""
    marks = sorted(0.5 * (s + e) for s, e, n in host if n == CLOCK)
    stamps = sorted(s["clock_ns"] for s in spans if s["clock_ns"] is not None)
    k = min(len(marks), len(stamps))
    if not k:
        return None
    off = statistics.median(round(m * 1e9) - t for m, t in zip(marks[-k:], stamps[-k:]))
    return [{**s, "start_s": (s["start_ns"] + off) / 1e9, "end_s": (s["end_ns"] + off) / 1e9}
            for s in spans]


# ---------------------------------------------------------------------------
# the profiler
# ---------------------------------------------------------------------------


def _write_spans(log_dir: str) -> None:
    """`spans.json` beside `trace.json`: the recorded spans as complete
    ("X") events on trace.json's clock (ts and dur in us) and the counters."""
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    host = [(e["ts"] / 1e6, (e["ts"] + e.get("dur", 0)) / 1e6, e["name"])
            for e in events if e.get("name") == CLOCK and e.get("ph") == "X"]
    rec = recorded()
    spans = on_trace(rec["spans"], host) or []
    out = [{"name": s["name"], "ph": "X", "pid": "nsc spans", "tid": s["unit"],
            "ts": 1e6 * s["start_s"], "dur": 1e6 * (s["end_s"] - s["start_s"]),
            "args": {k: s[k] for k in ("id", "parent", "unit", "self_ms", "device_ms")}}
           for s in spans]
    with open(os.path.join(log_dir, "spans.json"), "w") as f:
        json.dump({"traceEvents": out, "counters": rec["counters"]}, f)


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block (CPU, and CUDA where present) and write
    `<log_dir>/trace.json` and `<log_dir>/spans.json` (the recorder,
    cleared on entry, as `_write_spans` lays it out)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    clear()
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        barrier()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    _write_spans(log_dir)


def _intervals(prof):
    """(device intervals (start, end, name), host intervals (start, end)) in
    microseconds, from the profiler's events (kernels, copies and fills
    are its CUDA events)."""
    kernels, host = [], []
    for ev in prof.events():
        span = (ev.time_range.start, ev.time_range.end)
        if str(ev.device_type).split(".")[-1] == "CUDA":
            kernels.append((*span, ev.name))
        else:
            host.append(span)
    return kernels, host


def summarize(prof, top: int = 10) -> dict:
    """The device work of a finished `trace` (kernels, copies, fills): the
    `top` by self device time (name, calls, total and mean ms), their total
    and count, the window's wall (first host op or kernel start to last
    end, ms), the busy time (the union of the device intervals) and the idle
    share (wall minus busy, over wall). "top" is empty, and the idle share
    None, where the trace holds no device work."""
    kernels, host = _intervals(prof)
    by_name: Dict[str, list] = defaultdict(lambda: [0, 0.0])
    for start, end, name in kernels:
        by_name[name][0] += 1
        by_name[name][1] += (end - start) / 1e3
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    spans = kernels + [(s, e, None) for s, e in host]
    out = {"top": [{"name": n, "calls": c, "ms": ms, "mean_ms": ms / c}
                   for n, (c, ms) in ranked[:top]],
           "kernel_ms": sum(ms for _, (_, ms) in ranked), "kernel_launches": len(kernels),
           "wall_ms": None, "busy_ms": None, "idle_share": None}
    if not kernels:
        return out
    t0 = min(s for s, _, _ in spans)
    t1 = max(e for _, e, _ in spans)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e, _ in sorted(kernels):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    wall = max(t1 - t0, 1e-9)
    out.update(wall_ms=wall / 1e3, busy_ms=busy / 1e3, idle_share=1.0 - busy / wall)
    return out
