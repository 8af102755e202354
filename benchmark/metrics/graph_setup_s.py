"""Capture plus instantiation seconds of every CUDA graph the run's
program captured (``infer/graphs.py::CapturedGraph``'s ``capture_s`` and
``instantiate_s``); nothing where the program captures none."""


def read(record, ctx):
    return record.get("graph_setup_s") or None
