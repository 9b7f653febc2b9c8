"""The traced window: `torch.profiler` over CPU and CUDA activities, read
into device intervals, the busy and idle time (the arithmetic of the port's
`nsc_tpu_torch.utils.profiling.summarize`: wall minus the union of the
device intervals, over wall) and the run's `breakdown`.
"""

from __future__ import annotations

import re
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch

# kernels of the port's own (csrc/*.cu), by the names the trace prints
PORT_KERNELS = {
    "K1": re.compile(r"\bresidual_stack(_tc)?_kernel"),
    "K2": re.compile(r"\brvq_(quantize|split_planes)_kernel"),
    "K3": re.compile(r"\brvq_dequantize(_rowwarp)?_kernel"),
    "K4": re.compile(r"\bstft_magnitude\w*_kernel"),
    "K5": re.compile(r"\bfused_stage(_tc)?_kernel"),
    "K6": re.compile(r"\bresidual_stack_cl(_tc)?_kernel"),
}
_COPY = re.compile(r"^(Memcpy|Memset)|^cudaMem", re.I)


def kernel_of(name: str):
    """The port kernel ("K1".."K6") a device event belongs to, or None."""
    for k, rx in PORT_KERNELS.items():
        if rx.search(name):
            return k
    return None


def is_copy(name: str) -> bool:
    return bool(_COPY.search(name))


@dataclass
class Trace:
    """Device events (start, end, name) and host events (start, end, name)
    of a traced window, in seconds."""

    device: List[Tuple[float, float, str]] = field(default_factory=list)
    host: List[Tuple[float, float, str]] = field(default_factory=list)

    @classmethod
    def from_profiler(cls, prof) -> "Trace":
        tr = cls()
        for ev in prof.events():
            span = (ev.time_range.start / 1e6, ev.time_range.end / 1e6, ev.name)
            if str(ev.device_type).split(".")[-1] == "CUDA":
                tr.device.append(span)
            else:
                tr.host.append(span)
        tr.device.sort()
        return tr

    def wall_s(self) -> float:
        spans = self.device + self.host
        if not spans:
            return 0.0
        return max(e for _, e, _ in spans) - min(s for s, _, _ in spans)

    def busy_intervals(self) -> List[Tuple[float, float]]:
        merged: List[List[float]] = []
        for s, e, _ in self.device:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def time_by(self, pred) -> float:
        return sum(e - s for s, e, n in self.device if pred(n))

    def count_by(self, pred) -> int:
        return sum(1 for _, _, n in self.device if pred(n))

    def top_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, float] = defaultdict(float)
        for s, e, name in self.device:
            by[name] += e - s
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10, min_gap_s: float = 2e-6) -> List[list]:
        """The device's idle gaps inside the window, each named by the
        innermost host event running at its middle ("(outside torch ops)" where
        none is), summed by name; the `n` largest sums."""
        busy = self.busy_intervals()
        gaps = [(e0, s1) for (_, e0), (s1, _) in zip(busy, busy[1:]) if s1 - e0 >= min_gap_s]
        host = sorted(self.host)
        by: Dict[str, float] = defaultdict(float)
        active: List[Tuple[float, float, str]] = []
        i = 0
        for g0, g1 in gaps:
            mid = 0.5 * (g0 + g1)
            while i < len(host) and host[i][0] <= mid:
                active.append(host[i])
                i += 1
            active = [h for h in active if h[1] >= mid]
            name = min(active, key=lambda h: h[1] - h[0])[2] if active else "(outside torch ops)"
            by[name] += g1 - g0
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def profile():
    """A profiler over CPU and CUDA activities (enter it around the window)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts)
