"""Device milliseconds of a step's update phase (both Adam updates, the RVQ
EMA and the reseed draw): the CUDA-event time of the program's
`train.update` span, the mean over the traced steps. The recorder holds
the process's one traced window: the harness traces once a process, and
never clears it. Nothing where the program records no such span, or
records it off a CUDA device."""


def read(ctx):
    try:
        from nsc_tpu_torch.utils.profiling import recorded
    except ImportError:
        return None
    ms = [s["device_ms"] for s in recorded()["spans"] if s["name"] == "train.update"]
    if not ms or None in ms:
        return None
    return sum(ms) / len(ms)
