"""Host seconds inside the program's train step (its span ``train.step``,
``qaig_tpu_torch/utils/spans.py``, recorded while the profiler runs) over
the traced slice's seconds: near 1, the step holds the host; near 0, the
host is free to queue steps ahead.  Nothing where the program records no
such span."""

import sys


def read(record, ctx):
    spans = sys.modules.get("qaig_tpu_torch.utils.spans")
    if spans is None or not record.get("trace"):
        return None
    seconds = spans.totals().get("train.step")
    if seconds is None:
        return None
    return seconds / record["trace"]["window_s"]
