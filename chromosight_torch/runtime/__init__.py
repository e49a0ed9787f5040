"""Per-genome and per-chromosome runtime (band path)."""
