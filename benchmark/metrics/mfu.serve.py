"""Share of the bf16 tensor-core peak: the FLOPs that encode (encoder and
search) and decode (decoder) of the traced window's batches need at the
clips' own length, over the traced window."""

from benchmark.harness import flops, peaks


def read(ctx):
    if ctx["busy_s"] <= 0:
        return None
    t = ctx["traffic"]
    samples = int(round(t["clip_seconds"] * t["sample_rate"]))
    work = ctx["units"] * flops.serve_flops(ctx["codec"], t["batch"], samples)
    return 100.0 * work / ctx["window_s"] / peaks.PEAK_BF16_FLOPS
