"""Named host-side spans of the port, on the profiler's clock.

``with span("train.step"):`` costs one check of a flag while no
``torch.profiler`` records: no option turns spans on.  While one records
(the benchmark's ``--trace 1`` slice, the trainers' ``--profile-dir``,
``generate_images --profile-dir``), a span opens a host-side record
function of its name, so it shows in the Kineto trace on the kernels'
clock (on the thread that started the profiler; the profiler follows
other threads only under its ``profile_all_threads`` option), and appends
``(name, start_ns, end_ns)`` to a bounded list of the last
:data:`CAPACITY` spans, whatever the thread.  The record function is an
operator's (``_RecordFunctionFast``), not ``torch.profiler.record_function``'s
user annotation: for a user annotation Kineto also draws a range on the
card over the kernels that the span launched, which a reader of the
device's records takes for a kernel and for busy time.  :func:`totals`
sums the list's seconds by name; :func:`reset` clears it.

No span may sit inside a function captured in a CUDA graph: it would run
once at the capture and never at a replay.  Counts of what a replay runs
live in ``infer/graphs.py::replay_counters`` instead.
"""

import collections
import time

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler

CAPACITY = 65536
_records = collections.deque(maxlen=CAPACITY)


class span:
    """``with span(name):`` a named span: a no-op unless a profiler
    records."""

    __slots__ = ("name", "_fn", "_start")

    def __init__(self, name):
        self.name, self._fn = name, None

    def __enter__(self):
        if not _profiler._is_profiler_enabled:
            return self
        self._fn = _RecordFunctionFast(self.name)
        self._fn.__enter__()
        self._start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self._fn is None:
            return False
        _records.append((self.name, self._start, time.perf_counter_ns()))
        fn, self._fn = self._fn, None
        fn.__exit__(*exc)
        return False


def records():
    """A copy of the list, oldest first."""
    return list(_records)


def reset():
    _records.clear()


def totals():
    """``{name: seconds}`` over the list."""
    out = {}
    for name, start, end in records():
        out[name] = out.get(name, 0.0) + (end - start) / 1e9
    return out
