"""The share of the traced slice in which no kernel ran on the card
(``torch.profiler``: one less the union of the kernels' intervals over
the slice's host-clock length)."""

from benchmark.metrics._trace import idle_share


def read(record, ctx):
    return idle_share(record)
