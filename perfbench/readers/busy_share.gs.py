"""The share of the traced groundstate slice's wall in which the device ran an
operation, in %."""

from perfbench.readers._span import span


def read(ctx):
    got = span(ctx, "groundstate")
    return None if got is None else 100.0 * got[0]["busy_share"]
