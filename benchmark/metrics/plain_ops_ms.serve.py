"""Device milliseconds per batch in kernels that are not the port's own
(cuDNN convolutions, elementwise snakes, casts, pads); copies are left out."""

from benchmark.harness import trace


def read(ctx):
    if ctx["busy_s"] <= 0:
        return None
    tr = ctx["trace"]
    t = tr.time_by(lambda n: trace.kernel_of(n) is None and not trace.is_copy(n))
    return 1e3 * t / ctx["units"]
