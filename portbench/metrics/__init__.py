"""Per-layer metrics, one reader a metric: ``portbench/metrics/<name>.py``
defines ``read(reading) -> float | None`` over a ``tracing.Reading``. A
reader that finds nothing to read returns None, and the metric is left
out of the result line."""
