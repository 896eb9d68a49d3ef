"""H applies per S(q, omega) row of the window, counted as for
applies_per_groundstate."""


def read(ctx):
    return ctx.counts.get("applies.row")
