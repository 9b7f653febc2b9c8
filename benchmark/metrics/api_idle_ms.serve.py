"""Device-idle milliseconds a batch under the API's host work: the gaps
between the trace's device intervals whose innermost program span at their
middle is an `api.*` span other than `api.*.model` (the pads, the host
side of the copies, the trims), as `Trace.idle_gaps` names a gap by the
innermost host event. The spans come from `nsc_tpu_torch.utils.profiling`,
put on the trace's clock by its `nsc.clock` events; the recorder holds the
process's one traced window (the harness traces once a process). Nothing
where the program records no API spans."""

from benchmark.harness.trace import Trace


def read(ctx):
    try:
        from nsc_tpu_torch.utils.profiling import on_trace, recorded
    except ImportError:
        return None
    tr = ctx["trace"]
    spans = on_trace(recorded()["spans"], tr.host) if ctx["busy_s"] > 0 else None
    if not any(s["name"].startswith("api.") for s in spans or []):
        return None
    gaps = Trace(device=tr.device, host=[(s["start_s"], s["end_s"], s["name"]) for s in spans])
    idle = sum(v for k, v in gaps.idle_gaps(n=len(spans) + 1, min_gap_s=0.0)
               if k.startswith("api.") and not k.endswith(".model"))
    return 1e3 * idle / ctx["units"]
