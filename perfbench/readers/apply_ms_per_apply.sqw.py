"""Device ms per apply of the operations enqueued inside the port's
`apply.*` spans in the traced KPM row slice: the H apply alone (the
compact cell's on complex64 states; perfbench/readers/_program.py)."""

from perfbench.readers._program import APPLY, per_apply


def read(ctx):
    return per_apply(ctx, "row", "device", APPLY)
