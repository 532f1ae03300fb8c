"""Per-layer metrics: one reader per file, read(records) -> value or None."""
