"""Milliseconds from a traced step's start to the step's "generator" mark
(the generator's losses and gradients), a device sync at each, the mean
over the traced steps."""


def read(ctx):
    marks = [m for m in ctx["window"].get("marks", []) if "generator" in m]
    if not marks:
        return None
    return 1e3 * sum(m["generator"] - m["start"] for m in marks) / len(marks)
