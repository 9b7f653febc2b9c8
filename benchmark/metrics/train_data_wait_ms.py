"""Host milliseconds a traced step waited for its batch: the time inside the
program's `data.wait` spans (the `Prefetcher`'s queue `get`), over the
traced steps. The recorder holds the process's one traced window: the
harness traces once a process, and never clears it. Nothing where the
program records no such span."""


def read(ctx):
    try:
        from nsc_tpu_torch.utils.profiling import recorded
    except ImportError:
        return None
    ms = [s["ms"] for s in recorded()["spans"] if s["name"] == "data.wait"]
    if not ms:
        return None
    return sum(ms) / ctx["units"]
