"""Padding rows over all rows the batcher dispatched in the window
(``RequestBatcher.metrics()``' ``padded_rows_total`` and
``dispatches_by_batch`` deltas)."""


def read(record, ctx):
    c = record.get("serve_counters")
    if not c or not c["rows"] + c["padded"]:
        return None
    return c["padded"] / (c["rows"] + c["padded"])
