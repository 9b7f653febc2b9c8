"""K4 (the loss STFT magnitude) against its roofline: the least time of the
step's loss bank (`bounds.k4_step_bound_s`: each resolution and the mel
size, on the reconstruction and the target), times the traced steps, over
K4's traced device time."""

from benchmark.harness import bounds, trace


def read(ctx):
    if ctx["busy_s"] <= 0:
        return None
    spent = ctx["trace"].time_by(lambda n: trace.kernel_of(n) == "K4")
    if spent <= 0:
        return None
    t = ctx["traffic"]
    samples = int(round(t["segment_seconds"] * t["sample_rate"]))
    training = ctx["cell"].config["training"]
    return 100.0 * ctx["units"] * bounds.k4_step_bound_s(training, t["batch"], samples) / spent
