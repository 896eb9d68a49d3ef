"""vecop_ms_per_apply.gs on the shared synthetic trace: the groundstate
slice's device ms outside K1 (the dot2 and the add) over its 20 applies."""

EXPECTED = (0.045 - 0.03) / 20
