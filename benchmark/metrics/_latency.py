"""Percentiles of the latencies of every request due in the window, from
its due time to the return of its last image; a request refused or
failed, or never answered, counts as infinitely late."""

import math


def percentile(record, q):
    """The nearest-rank ``q`` percentile, or None when one of the
    requests it covers never came (inf is not a number the line can
    carry)."""
    values = sorted(record["latencies"])
    if not values:
        return None
    rank = max(1, math.ceil(q / 100.0 * len(values)))
    value = values[rank - 1]
    return None if math.isinf(value) else value
