"""ell_apply_roofline on the shared synthetic trace: the probes' apply bound
over the apply's CUDA-event time."""

EXPECTED = 100 * 1.435 / 40.0
