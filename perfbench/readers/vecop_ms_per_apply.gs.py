"""Device ms per apply outside K1 in the traced ground-state (restart-cycle) slice: the solvers'
vector operations (dots, axpys, norms) and the apply's torch seeds and
tails."""

from perfbench.readers._span import span


def read(ctx):
    got = span(ctx, "groundstate")
    if got is None or got[0]["k1_launches"] == 0:
        return None
    s, n = got
    return (s["device_ms"] - s["k1_ms"]) / n
