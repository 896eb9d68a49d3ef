"""Per-layer readers: one module per metric, found by the metric's name."""
