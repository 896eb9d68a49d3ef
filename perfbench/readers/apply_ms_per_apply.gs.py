"""Device ms per apply of the operations enqueued inside the port's
`apply.*` spans in the traced ground-state slice: the H apply alone, its
seeds and tails included (perfbench/readers/_program.py)."""

from perfbench.readers._program import APPLY, per_apply


def read(ctx):
    return per_apply(ctx, "groundstate", "device", APPLY)
