"""Decode attention's share of its roofline in the traced generate calls:
the least time of the decode-attention work those calls hold
(``counts.decode_attention_launches``: each launch bound by its operations
over the bf16 peak or its bytes over the memory bandwidth) over the device
seconds of the kernels that do it, in percent.  The kernels are found by
name: the shared-prefix decode kernels (B and C, ``prefix_split_kernel``)
and the flat one (``flat_split_kernel``)."""

from benchmark import counts, peaks
from benchmark.metrics._trace import summary
from benchmark.trace import kernel_seconds

KERNELS = ("prefix_split_kernel", "flat_split_kernel")


def read(record, ctx):
    t = summary(record)
    flops = peaks.peak_flops(ctx.kind, ctx.config["dtype"])
    bw = peaks.peak_bytes(ctx.kind)
    if t is None or flops is None:
        return None
    secs, _ = kernel_seconds(t, KERNELS)
    if not secs:
        return None
    work = counts.decode_attention_launches(ctx.config, record["batch"])
    return (100.0 * record["trace_calls"]
            * counts.least_seconds(work, flops, bw) / secs)
