"""The least time of one compensated dot of two states of the cell's shape
(each operand's stored elements read once from HBM) over the dot2 kernel's
CUDA-event time on them (median of 16 after 3), in %."""


def read(ctx):
    p = ctx.probes
    if not p.get("dot_ms"):
        return None
    return 100.0 * p["dot_bound_ms"] / p["dot_ms"]
