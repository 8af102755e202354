"""Shared arithmetic of the readers of a traced slice."""


def summary(record):
    """The trace summary, or None where the slice ran no device work."""
    t = record.get("trace")
    if not t or not t["busy_s"] or not t["n_kernels"]:
        return None
    return t


def idle_share(record):
    t = summary(record)
    if t is None:
        return None
    return max(0.0, 1.0 - t["busy_s"] / t["window_s"])
