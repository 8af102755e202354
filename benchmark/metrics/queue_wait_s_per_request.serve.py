"""Seconds a request served in the window waited in the batcher's queue,
from submission to its dispatch, on average: the window's change in
``RequestBatcher.metrics()``' ``queue_wait_seconds_total`` over its
change in ``served_requests_total`` (program counters)."""


def read(record, ctx):
    c = record.get("serve_counters")
    if not c or not c["served"]:
        return None
    return c["queue_wait_s"] / c["served"]
