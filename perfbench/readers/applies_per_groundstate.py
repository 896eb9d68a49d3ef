"""H applies per ground-state unit of the window (kron: K1's launches over
its launches in one apply; compact: forward calls of the apply module)."""


def read(ctx):
    return ctx.counts.get("applies.groundstate")
