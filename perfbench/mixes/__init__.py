"""Traffic mixes: one module per kind, found by the traffic file's "mix"."""
