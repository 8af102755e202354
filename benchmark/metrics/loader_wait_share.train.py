"""Seconds the train loop waited on the port's loader for its next batch
(the benchmark's own span around ``next()``) over the window."""


def read(record, ctx):
    return record["loader_wait_s"] / record["window_s"]
