"""K1's device ms per apply in the traced ground-state slice."""

from perfbench.readers._span import span


def read(ctx):
    got = span(ctx, "groundstate")
    if got is None or got[0]["k1_launches"] == 0:
        return None
    s, n = got
    return s["k1_ms"] / n
