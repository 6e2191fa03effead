"""Per-layer readers: one file per metric, found by its name."""
