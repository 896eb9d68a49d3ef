"""dot2_roofline on the shared synthetic trace: the probes' dot bound over the
dot's CUDA-event time."""

EXPECTED = 90.0
