"""Per-layer metric readers, one module a metric, named as the metric in
``BENCHMARK.json``: ``read(record) -> float | None`` over a traced run's
``trace.Record``.  A reader that finds nothing to read returns None, and
the harness leaves the metric out of the result line."""
