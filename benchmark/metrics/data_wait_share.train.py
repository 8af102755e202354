"""Seconds the loader's consumer waited for its next batch, measured
inside the loader (its span ``data.wait``,
``qaig_tpu_torch/utils/spans.py``, recorded while the profiler runs),
over the traced slice's seconds.  Nothing where the program records no
such span.

The span's seconds are the totals that the driver keeps in the traced
slice's record (``trace["spans"]``); a record made without them (a test's)
is read from the program's span list itself."""

import sys


def read(record, ctx):
    trace = record.get("trace")
    if not trace:
        return None
    totals = trace.get("spans")
    if totals is None:
        spans = sys.modules.get("qaig_tpu_torch.utils.spans")
        totals = spans.totals() if spans else {}
    seconds = totals.get("data.wait")
    if seconds is None:
        return None
    return seconds / record["trace"]["window_s"]
