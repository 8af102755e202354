"""Process start to the window's start: building, weights, data, warm-up
and every CUDA graph capture (host clock)."""


def read(record, ctx):
    return record["setup_s"]
