"""Device kernels (copies and sets included) in the traced generate
calls over their images."""

from benchmark.metrics._trace import summary


def read(record, ctx):
    t = summary(record)
    if t is None:
        return None
    return t["n_kernels"] / (record["trace_calls"] * record["batch"])
