"""vecop_ms_per_apply.sqw on the shared synthetic trace: the row slice runs no
K1, so it has no apply to divide by."""

EXPECTED = None
