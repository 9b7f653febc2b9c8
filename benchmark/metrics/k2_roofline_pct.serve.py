"""K2 (the residual search) against its roofline in the offline cells: its
least time at M = the batch's frames at the clips' own length
(`bounds.k2_bound_s`), per traced batch, over K2's traced device time (the
search kernel and its split of the books)."""

import math

from benchmark.harness import bounds, trace


def read(ctx):
    if ctx["busy_s"] <= 0:
        return None
    t, c = ctx["traffic"], ctx["codec"]
    spent = ctx["trace"].time_by(lambda n: trace.kernel_of(n) == "K2")
    if spent <= 0:
        return None
    frames = int(round(t["clip_seconds"] * t["sample_rate"])) // math.prod(c["strides"])
    return 100.0 * ctx["units"] * bounds.k2_bound_s(c, t["batch"] * frames) / spent
