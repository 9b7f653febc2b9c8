"""Device kernels launched per chunk round (encoder push and decoder push),
copies left out, from the trace."""

from benchmark.harness import trace


def read(ctx):
    if ctx["busy_s"] <= 0:
        return None
    return ctx["trace"].count_by(lambda n: not trace.is_copy(n)) / ctx["units"]
