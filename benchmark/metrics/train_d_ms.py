"""Milliseconds from a traced step's "generator" mark to its
"discriminator" mark (the discriminators' loss and gradients), a device
sync at each, the mean over the traced steps."""


def read(ctx):
    marks = [m for m in ctx["window"].get("marks", []) if "discriminator" in m]
    if not marks:
        return None
    return 1e3 * sum(m["discriminator"] - m["generator"] for m in marks) / len(marks)
