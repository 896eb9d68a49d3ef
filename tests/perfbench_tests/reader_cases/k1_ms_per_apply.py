"""k1_ms_per_apply on the shared synthetic trace: the groundstate slice's two
K1 launches over its 20 applies."""

EXPECTED = 0.03 / 20
