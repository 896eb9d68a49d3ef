"""The least time of the kron H apply (K1 and its torch seeds and tails): the state read and H psi written once, or 2 nnz at the peak rate, whichever is longer, at the data sheet's rates, over the apply's
CUDA-event time on a state of the cell's shape (median of 16 after 3), in
%."""


def read(ctx):
    p = ctx.probes
    if not p.get("apply_ms"):
        return None
    return 100.0 * p["apply_bound_ms"] / p["apply_ms"]
