"""The process mesh (counterpart of ``qaig_tpu/parallel/mesh.py``).

``qaig_tpu`` lays its devices out as a ``jax.sharding.Mesh`` with axes
``('data', 'model')``, or ``('data', 'pipe', 'model')`` under pipeline
parallelism.  Here each rank of the process group is one device of that
mesh: ranks are laid out row-major, as ``np.asarray(devices).reshape(
n_data, n_pipe, n_model)`` lays out devices, so rank r sits where device r
sits in the JAX mesh.  A :class:`Mesh` holds the axis sizes, this rank's
coordinates and one process group per axis (the ranks that differ only in
that coordinate).  A single-process run has a 1x1 mesh with no groups, and
its code paths run no collective.

A process cannot sit out a run (the trainers and the generator are one
program on every rank), so where :func:`make_mesh_for_batch` would leave
processes idle it logs ``qaig_tpu``'s warning and raises.
"""

import logging as _logging

import numpy as np
import torch
import torch.distributed as dist

from qaig_tpu_torch.parallel import comm

_log = _logging.getLogger("qaig_tpu_torch")


class Mesh:
    """Axis sizes (``shape``: data, model, and pipe when it is above 1),
    this rank's coordinates and a process group per axis (None in a
    single-process run)."""

    def __init__(self, shape, coords, groups, ranks):
        self.shape = shape
        self.coords = coords
        self.groups = groups
        self.ranks = ranks   # the global ranks of each group, by axis

    @property
    def distributed(self):
        return bool(self.groups)

    def size(self, axis):
        return self.shape.get(axis, 1)

    def index(self, axis):
        return self.coords.get(axis, 0)

    def group(self, axis):
        return self.groups.get(axis)

    def describe(self):
        text = f"data={self.size('data')} x model={self.size('model')}"
        if self.size("pipe") > 1:
            text += f" x pipe={self.size('pipe')}"
        return text


def _warm(group, device):
    """Create the group's communicator (None: the default group's) now,
    outside any CUDA-graph capture: NCCL builds it at the group's first
    collective."""
    dist.all_reduce(torch.zeros(1, device=device), group=group)


def make_mesh(n_data=None, n_model=1, n_pipe=1, device=None):
    """The ('data', 'model') mesh, or ('data', 'pipe', 'model') with
    ``n_pipe > 1``, over the run's processes (all on the data axis by
    default).  ``device``: where the communicators are warmed."""
    n = comm.world_size()
    if n_data is None:
        n_data = max(n // (n_model * n_pipe), 1)
    use = n_data * n_model * n_pipe
    if use > n:
        raise ValueError(f"Mesh {n_data}x{n_pipe}x{n_model} needs {use} "
                         f"processes, have {n}.")
    if use < n:
        raise ValueError(f"Mesh {n_data}x{n_pipe}x{n_model} uses {use} of "
                         f"{n} processes; a process cannot sit idle: start "
                         f"{use} processes, or change the batch or the "
                         f"shard counts so that all {n} are used.")
    shape = {"data": n_data, "model": n_model}
    if n_pipe > 1:
        shape["pipe"] = n_pipe
    if not comm.active():
        return Mesh(shape, {}, {}, {})
    layout = np.arange(n).reshape(n_data, n_pipe, n_model)
    me = np.argwhere(layout == comm.rank())[0]
    axes = {"data": 0, "pipe": 1, "model": 2}
    coords, groups, ranks = {}, {}, {}
    for axis, dim in axes.items():
        if axis == "pipe" and n_pipe == 1:
            continue
        # every rank creates every group of the axis, in one order
        lines = np.moveaxis(layout, dim, -1).reshape(-1, layout.shape[dim])
        for line in lines:
            group = dist.new_group([int(r) for r in line])
            if comm.rank() in line:
                groups[axis], ranks[axis] = group, [int(r) for r in line]
        coords[axis] = int(me[dim])
    warm_on = device if device is not None else (
        torch.device("cuda", torch.cuda.current_device())
        if comm.backend() == "nccl" else torch.device("cpu"))
    # and the default group's: the global-norm clip reduces over all ranks
    for group in (None, *groups.values()):
        _warm(group, warm_on)
    return Mesh(shape, coords, groups, ranks)


def make_mesh_for_batch(batch_size, n_model=1, n_pipe=1, device=None):
    """A mesh whose data axis is the largest divisor of ``batch_size`` that
    fits the processes (under pipeline parallelism callers pass the
    microbatch).  Where that leaves processes idle it logs ``qaig_tpu``'s
    warning and raises (:func:`make_mesh`)."""
    n = comm.world_size()
    cap = max(n // (n_model * n_pipe), 1)
    n_data = max(d for d in range(1, cap + 1) if batch_size % d == 0)
    used = n_data * n_model * n_pipe
    if used < n:
        unit = "microbatch" if n_pipe > 1 else "batch"
        shape = (f"{n_data}x{n_pipe}x{n_model}" if n_pipe > 1
                 else f"{n_data}x{n_model}")
        _log.warning(
            "Mesh %s uses %d of %d devices (%s %d not divisible by "
            "more); %d chips idle — pad the %s to a multiple of %d to "
            "use them all.", shape, used, n, unit, batch_size, n - used,
            unit, cap)
    return make_mesh(n_data=n_data, n_model=n_model, n_pipe=n_pipe,
                     device=device)
