"""K1 (the residual-stack kernel) against its roofline: the least time of
its 8 stages' units on the traced batches at the clips' own length
(`bounds.k1_bound_s`), over K1's traced device time. Nothing where K1 did
not run."""

from benchmark.harness import bounds, trace


def read(ctx):
    if ctx["busy_s"] <= 0:
        return None
    t = ctx["traffic"]
    spent = ctx["trace"].time_by(lambda n: trace.kernel_of(n) == "K1")
    if spent <= 0:
        return None
    samples = int(round(t["clip_seconds"] * t["sample_rate"]))
    least = ctx["units"] * bounds.k1_bound_s(ctx["codec"], t["batch"], samples)
    return 100.0 * least / spent
