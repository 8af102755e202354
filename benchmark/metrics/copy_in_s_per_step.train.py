"""Host seconds in the program's copies of a graph's inputs before each
replay (its span ``graph.copy_in``, ``qaig_tpu_torch/utils/spans.py``,
recorded while the profiler runs) over the traced steps.  Nothing where
the program records no such span."""

import sys


def read(record, ctx):
    spans = sys.modules.get("qaig_tpu_torch.utils.spans")
    if spans is None or not record.get("trace"):
        return None
    seconds = spans.totals().get("graph.copy_in")
    if seconds is None:
        return None
    return seconds / record["trace_steps"]
