"""solver_idle_ms_per_apply.gs on the shared synthetic trace: the shared
context's slices carry no raw events, so no program span is booked (the
values on a slice with spans: test_perfbench_program.py)."""

EXPECTED = None
