"""applies_per_row on the shared synthetic trace: the counter `applies.row` of
the shared context."""

EXPECTED = 101.0
