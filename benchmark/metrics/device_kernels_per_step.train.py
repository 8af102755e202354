"""Device kernels (copies and sets included) in the traced train steps
over the steps."""

from benchmark.metrics._trace import summary


def read(record, ctx):
    t = summary(record)
    if t is None:
        return None
    return t["n_kernels"] / record["trace_steps"]
