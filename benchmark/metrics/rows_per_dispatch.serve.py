"""Requested image rows per dispatch of the batcher over the window:
``RequestBatcher.metrics()``' deltas (rows dispatched, by padded size,
less the padding, over the dispatches)."""


def read(record, ctx):
    c = record.get("serve_counters")
    if not c or not c["dispatches"]:
        return None
    return c["rows"] / c["dispatches"]
