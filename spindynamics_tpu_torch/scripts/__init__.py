"""The JAX package's measurement scripts on the port, one module per
script under the same name, each run with
`python -m spindynamics_tpu_torch.scripts.<name> [arguments]` on the card:
bench_kron (the kron apply beside the sector_blocked apply) and
mxu_calibrate (the card's matrix-product and copy rates). Each prints JSON
lines and, with no CUDA device, exits non-zero before it prints any.
"""
