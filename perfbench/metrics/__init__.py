"""Per-layer metrics, one reader a file: ``read(ctx)`` returns the number,
or None where the traced window holds nothing to read."""
