"""Device ms per apply of the operations enqueued inside the port's
`lanczos.*` and `kpm.*` spans in the traced KPM row slice: the
recurrence's shift, scale, three-term step and dots without the apply
(perfbench/readers/_program.py)."""

from perfbench.readers._program import SOLVER, per_apply


def read(ctx):
    return per_apply(ctx, "row", "device", SOLVER)
