"""Device ms per apply of the operations enqueued inside the port's
`lanczos.*` and `kpm.*` spans in the traced ground-state slice: the
solvers' vector operations (dots, axpys, norms) without the apply
(perfbench/readers/_program.py)."""

from perfbench.readers._program import SOLVER, per_apply


def read(ctx):
    return per_apply(ctx, "groundstate", "device", SOLVER)
