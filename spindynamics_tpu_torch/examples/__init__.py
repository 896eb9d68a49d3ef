"""The JAX package's examples and its two ground-state scripts on the port.

One module per JAX file, under the same name (examples/example*.py,
scripts/gs_ladder.py, scripts/l32_groundstate.py), each run with
`python -m spindynamics_tpu_torch.examples.<name> [arguments]`. Each has
`run(...)`, which takes keyword arguments and returns the numbers (no plot,
no file), and `main(argv=None)`, which parses the JAX script's positional
arguments plus --device (the card by default), --dtype, --seed and
--out-dir, prints one JSON line per stage and writes its plot and data only
under --out-dir (default build/examples/).

The kron modules (example_large_L, gs_ladder, l32_groundstate,
example_kron_*) run every H apply through K1 on the card, and the
trajectories and typicality through K2; the flat modules (example,
example_kpm, example_kpm_dos, example_kpm_sqw, example_lanczos_sqw) build
the JAX package's default layout, compact, whose apply is plain torch.
"""
