"""Host milliseconds a round spent issuing the model's work: the time inside
the program's `stream.encode.model` and `stream.decode.model` spans (the
streaming convs, projections, quantize and dequantize, launched without a
sync), over the traced rounds. The recorder holds the process's one traced
window: the harness traces once a process, and never clears it. Nothing
where the program records no such spans."""

MODEL = ("stream.encode.model", "stream.decode.model")


def read(ctx):
    try:
        from nsc_tpu_torch.utils.profiling import recorded
    except ImportError:
        return None
    ms = [s["ms"] for s in recorded()["spans"] if s["name"] in MODEL]
    if not ms:
        return None
    return sum(ms) / ctx["units"]
