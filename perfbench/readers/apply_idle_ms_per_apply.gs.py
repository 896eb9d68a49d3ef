"""Idle ms per apply of the traced ground-state slice whose gap began while
the host was inside an `apply.*` span: the device waiting on the apply's
launches (perfbench/readers/_program.py)."""

from perfbench.readers._program import APPLY, per_apply


def read(ctx):
    return per_apply(ctx, "groundstate", "idle", APPLY)
