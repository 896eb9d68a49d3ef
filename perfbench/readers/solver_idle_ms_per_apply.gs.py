"""Idle ms per apply of the traced ground-state slice whose gap began while
the host was inside a `lanczos.*` or `kpm.*` span: the device waiting on
the solver's launches (perfbench/readers/_program.py)."""

from perfbench.readers._program import SOLVER, per_apply


def read(ctx):
    return per_apply(ctx, "groundstate", "idle", SOLVER)
