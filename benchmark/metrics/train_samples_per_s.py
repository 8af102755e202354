"""Samples of the window's train steps over the window's seconds (host
clock, to a synchronise after the last step)."""


def read(record, ctx):
    return record["samples"] / record["window_s"]
