"""The share of the traced row slice's wall in which the device ran an
operation, in %."""

from perfbench.readers._span import span


def read(ctx):
    got = span(ctx, "row")
    return None if got is None else 100.0 * got[0]["busy_share"]
