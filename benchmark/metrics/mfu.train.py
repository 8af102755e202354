"""The traced train steps as a share of the card's dense float32 peak
(outside the tensor cores): the model's products of those steps
(``counts.train_step_flops``) over the device's span of them (first
kernel's start to last kernel's end, from the trace), in percent."""

from benchmark import counts, peaks
from benchmark.metrics._trace import summary


def read(record, ctx):
    t = summary(record)
    peak = peaks.peak_flops(ctx.kind, ctx.config["dtype"])
    if t is None or peak is None or not t.get("span_s"):
        return None
    flops = counts.train_step_flops(ctx.config, record["batch"])
    return 100.0 * flops * record["trace_steps"] / t["span_s"] / peak
