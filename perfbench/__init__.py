"""The benchmark of spindynamics_tpu_torch on NVIDIA H100 cards, on the
contract of BENCHMARK.json: `python3 perfbench/run.py --workload NAME
--seed N --seconds S --trace 0|1` runs one cell's window and prints one
JSON line. See perfbench/run.py."""
