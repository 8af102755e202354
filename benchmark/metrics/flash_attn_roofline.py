"""Self-attention's share of its roofline in the traced train steps: the
least time of the forward and backward attention work of those steps
(``counts.flash_attention_work``, float32 peak outside the tensor cores)
over the device seconds of the kernels that do it (kernel A's forward,
``flash_attention_fwd``, and A''s backward, ``flash_bwd_``), in
percent."""

from benchmark import counts, peaks
from benchmark.metrics._trace import summary
from benchmark.trace import kernel_seconds

KERNELS = ("flash_attention_fwd", "flash_bwd_")


def read(record, ctx):
    t = summary(record)
    flops = peaks.peak_flops(ctx.kind, ctx.config["dtype"])
    bw = peaks.peak_bytes(ctx.kind)
    if t is None or flops is None:
        return None
    secs, _ = kernel_seconds(t, KERNELS)
    if not secs:
        return None
    work = counts.flash_attention_work(ctx.config, record["batch"])
    return (100.0 * record["trace_steps"]
            * counts.least_seconds(work, flops, bw) / secs)
