"""Images of the window's generate calls over the window's seconds (host
clock: the window closes when its last call has returned)."""


def read(record, ctx):
    return record["images"] / record["window_s"]
