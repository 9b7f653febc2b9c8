"""Share of the float32 peak (the step runs with TF32 off): the FLOPs one
GAN step needs at the cell's shapes (`flops.train_step_flops`: the codec
forward and backward with its search, the discriminators' forward once on
real and generated rows, their weight and input gradients), times the
traced steps, over the traced window."""

from benchmark.harness import flops, peaks


def read(ctx):
    if ctx["busy_s"] <= 0:
        return None
    t = ctx["traffic"]
    samples = int(round(t["segment_seconds"] * t["sample_rate"]))
    work = ctx["units"] * flops.train_step_flops(ctx["codec"], t["batch"], samples)
    return 100.0 * work / ctx["window_s"] / peaks.PEAK_F32_FLOPS
