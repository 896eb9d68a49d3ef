"""launches_per_apply.gs on the shared synthetic trace: the groundstate
slice's four kernel launches over its 20 applies."""

EXPECTED = 4 / 20
