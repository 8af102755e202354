"""The traced generate calls as a share of the card's dense bf16 peak:
the model's products of those calls (``counts.cascade_flops``) over the
device's span of them (first kernel's start to last kernel's end, from
the trace), in percent."""

from benchmark import counts, peaks
from benchmark.metrics._trace import summary


def read(record, ctx):
    t = summary(record)
    peak = peaks.peak_flops(ctx.kind, ctx.config["dtype"])
    if t is None or peak is None or not t.get("span_s"):
        return None
    flops = counts.cascade_flops(ctx.config, record["batch"])
    return 100.0 * flops * record["trace_calls"] / t["span_s"] / peak
