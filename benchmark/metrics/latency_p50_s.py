"""The median latency of the requests due in the window (``_latency``)."""

from benchmark.metrics._latency import percentile


def read(record, ctx):
    return percentile(record, 50)
