"""One run of one cell: set-up, the window (timed, or traced), the program
freed, the check against the reference, and the result line.

A traffic file's "kind" names the class that drives it: "offline"
(`offline.Offline`), "live" (`live.Live`) or "train" (`train.Train`).
"""

from __future__ import annotations

import importlib
import math

import torch

from benchmark.harness import common, spec
from benchmark.harness import trace as tracing

KINDS = {"offline": "benchmark.harness.offline:Offline",
         "live": "benchmark.harness.live:Live",
         "train": "benchmark.harness.train:Train"}


def kind_for(cell, seed: int, device):
    mod, _, cls = KINDS[cell.traffic["kind"]].partition(":")
    return getattr(importlib.import_module(mod), cls)(cell, seed, device)


def traced_metrics(cell, drv, seconds: float):
    """The per-layer metrics of a traced window, its device time and its
    breakdown."""
    with tracing.profile() as prof:
        w = drv.window(seconds, max_units=drv.trace_units(), traced=True)
        common.sync(drv.dev)
    tr = tracing.Trace.from_profiler(prof)
    ctx = {"cell": cell, "codec": drv.codec, "traffic": cell.traffic, "window": w,
           "units": w["units"], "trace": tr, "window_s": tr.wall_s(), "busy_s": tr.busy_s()}
    metrics = {}
    for m in cell.per_layer:
        v = spec.metric_reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"busy_s": ctx["busy_s"], "window_s": ctx["window_s"]}
    breakdown = {"device_ops": tr.top_ops(10), "idle_gaps": tr.idle_gaps(10)}
    return w, metrics, device, breakdown


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float) -> dict:
    """The result object of one run (before the device fields the caller
    adds); `checks` holds each compared number beside its limit."""
    drv = kind_for(cell, seed, device)
    drv.setup()
    setup_s = common.now() - t0
    extra = {}
    if trace:
        w, metrics, extra["device"], extra["breakdown"] = traced_metrics(cell, drv, seconds)
    else:
        w = drv.window(seconds)
        names = {m["name"] for m in cell.end_to_end}
        metrics = {m["name"]: {"value": w["metrics"][m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in w["metrics"]}
        if "setup_s" in names:
            metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    peak = torch.cuda.max_memory_allocated(drv.dev) if drv.dev.type == "cuda" else 0
    drv.release()
    values = drv.check()
    checks = {k: {"value": v, "limit": cell.limits[k]["limit"]} for k, v in values.items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return {"correct": correct, "attempted": w["attempted"], "failed": w["failed"],
            "metrics": metrics, "memory_peak_bytes": peak, **extra, "checks": checks}
