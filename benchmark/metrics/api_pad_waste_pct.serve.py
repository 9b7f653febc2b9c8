"""Frames the model ran beyond those asked for, in % of those asked for:
100 x (`api.frames_run` / `api.frames` - 1), the program's counters of
`api.encode` and `api.decode` over the traced batches (the causal bucket's
power-of-two frame count against the clips' own). The counters hold the
process's one traced window: the harness traces once a process, and the
recorder is never cleared by it. Nothing where the program keeps no such
counters."""


def read(ctx):
    try:
        from nsc_tpu_torch.utils.profiling import recorded
    except ImportError:
        return None
    c = recorded()["counters"]
    if not c.get("api.frames"):
        return None
    return 100.0 * (c["api.frames_run"] / c["api.frames"] - 1.0)
