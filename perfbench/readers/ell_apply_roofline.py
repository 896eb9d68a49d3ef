"""The least time of the ell apply: its neighbour table read once, the state and the diagonal read and H psi written once, at the data sheet's rates, over the apply's
CUDA-event time on a state of the cell's shape (median of 16 after 3), in
%."""


def read(ctx):
    p = ctx.probes
    if not p.get("apply_ms"):
        return None
    return 100.0 * p["apply_bound_ms"] / p["apply_ms"]
