"""Per-layer metric readers, one module per metric, each with
``read(ctx) -> float | None``; ``None`` leaves the metric out of the line."""
