"""Tracing and timing (counterpart of `nsc_tpu/utils/profiling.py`).

  * `trace(dir)`: `torch.profiler.profile` over CPU and CUDA activities,
    writing a Chrome trace (`trace.json`, open in chrome://tracing or
    Perfetto) into `dir`; the profiler object is yielded, for `summarize`.
  * `summarize(prof)`: the traced window's device kernels by self time
    (top N) and its idle share: wall minus the union of the kernel
    intervals, over wall.
  * `timed(name)`: wall-clock block timing between two device barriers.
  * `Stopwatch`: accumulating named timers; `report()` gives
    {"time/<name>_ms": mean ms}.

`barrier(x)` synchronizes the CUDA device of `x` (or the current one when
`x` is None and CUDA is there); on the CPU it does nothing.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch


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


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block (CPU, and CUDA where present) and write
    `<log_dir>/trace.json`."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        barrier()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


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


@contextlib.contextmanager
def timed(name: str, results: Dict[str, float] | None = None) -> Iterator[None]:
    """Seconds the block took, between two barriers, into results[name]
    (printed in ms when results is None)."""
    barrier()
    start = time.perf_counter()
    yield
    barrier()
    dt = time.perf_counter() - start
    if results is not None:
        results[name] = dt
    else:
        print(f"[timed] {name}: {dt*1000:.2f} ms")


class Stopwatch:
    def __init__(self):
        self._acc = defaultdict(float)
        self._n = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name: str):
        start = time.perf_counter()
        yield
        self._acc[name] += time.perf_counter() - start
        self._n[name] += 1

    def report(self) -> Dict[str, float]:
        return {f"time/{k}_ms": 1000 * v / max(self._n[k], 1) for k, v in self._acc.items()}
