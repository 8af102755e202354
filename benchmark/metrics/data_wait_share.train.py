"""Seconds the loader's consumer waited for its next batch, measured
inside the loader (its span ``data.wait``,
``qaig_tpu_torch/utils/spans.py``, recorded while the profiler runs),
over the traced slice's seconds.  Nothing where the program records no
such span."""

import sys


def read(record, ctx):
    spans = sys.modules.get("qaig_tpu_torch.utils.spans")
    if spans is None or not record.get("trace"):
        return None
    seconds = spans.totals().get("data.wait")
    if seconds is None:
        return None
    return seconds / record["trace"]["window_s"]
