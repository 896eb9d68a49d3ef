"""Kernel launches per apply in the traced ground-state slice: the host's
work per Lanczos step."""

from perfbench.readers._span import span


def read(ctx):
    got = span(ctx, "groundstate")
    if got is None:
        return None
    s, n = got
    return s["launches"] / n
