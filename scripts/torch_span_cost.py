"""What a program span costs: `profiling.span` with no profiler running
(the shared null context) and under a profiler of the CPU (and of CUDA
where there is a card), in us a span, and a `count` with none running.

    python3 scripts/torch_span_cost.py [--n N]

Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from nsc_tpu_torch.utils import profiling  # noqa: E402


def _per_span_us(n: int) -> float:
    t0 = time.perf_counter()
    for _ in range(n):
        with profiling.span("cost"):
            pass
    return 1e6 * (time.perf_counter() - t0) / n


def cost(n: int) -> dict:
    out = {"device": torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu"}
    _per_span_us(1000)
    out["off_us"] = _per_span_us(n)
    t0 = time.perf_counter()
    for _ in range(n):
        profiling.count("cost", 1)
    out["count_off_us"] = 1e6 * (time.perf_counter() - t0) / n
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        torch.cuda.init()
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts):
        _per_span_us(100)
        out["on_us"] = _per_span_us(n // 10)
        with profiling.span("outer"):
            out["on_nested_us"] = _per_span_us(n // 10)
    profiling.clear()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=200000)
    args = ap.parse_args(argv)
    print(json.dumps(cost(args.n)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
