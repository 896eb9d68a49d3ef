"""applies_per_groundstate on the shared synthetic trace: the counter
`applies.groundstate` of the shared context."""

EXPECTED = 160.0
