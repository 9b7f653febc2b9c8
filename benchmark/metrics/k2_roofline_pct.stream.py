"""K2 (the residual search) against its roofline in the live cells: its
least time at M = streams x chunk frames (`bounds.k2_bound_s`), per traced
round, over K2's traced device time (the search kernel and its split of
the books)."""

import math

from benchmark.harness import bounds, trace


def read(ctx):
    if ctx["busy_s"] <= 0:
        return None
    t, c = ctx["traffic"], ctx["codec"]
    spent = ctx["trace"].time_by(lambda n: trace.kernel_of(n) == "K2")
    if spent <= 0:
        return None
    frames = int(round(t["chunk_seconds"] * t["sample_rate"])) // math.prod(c["strides"])
    return 100.0 * ctx["units"] * bounds.k2_bound_s(c, t["streams"] * frames) / spent
