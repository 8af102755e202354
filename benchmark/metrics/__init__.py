"""One reader a metric: ``read(record, ctx) -> value or None``; the harness
loads each file by the metric's name."""
