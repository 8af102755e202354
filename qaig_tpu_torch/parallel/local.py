"""The in-process mesh: one process driving several cards (counterpart of
``qaig_tpu/parallel/mesh.py::make_mesh`` when one process holds all the
devices, as ``qaig_tpu``'s server does with every local chip).

A :class:`LocalMesh` lays its devices out row-major as a ``(data,
model)`` grid, as ``np.asarray(devices).reshape(n_data, n_model)`` lays
out ``qaig_tpu``'s mesh.  Row ``d`` is data replica ``d``: its first
device is the replica's home card, which holds the replica's weights and
runs its work; its ``model`` devices hold the tensor-parallel shards of
every 2-layer MLP (:func:`shard_mlps_local_`).  The leading (batch) axis
splits into contiguous blocks of ``n / n_data`` rows
(:meth:`LocalMesh.batch_blocks`), as ``qaig_tpu.parallel.batch_sharding``
splits it over ``data``.

A device list may repeat a device (the CPU tests run a mesh of 8 ``cpu``
devices, as ``qaig_tpu``'s run on 8 virtual CPU devices; a one-card
machine can run a mesh that repeats ``cuda:0``); the serving CLI never
repeats one.

Tensor parallelism here needs no collective: :class:`LocalShards` copies
an MLP's input to each shard's card, runs the shard's products there and
sums the partial ``l1`` products on the home card in shard order.  It is
the in-process counterpart of ``parallel/comm.py::ModelShards`` and goes
through the same seam (``sum_partials``, ``zip``), so
``models/core.py::mlp2`` and ``models/blocks.py::packed_qkv`` take
either link.
"""

import copy
import logging as _logging

import torch

from qaig_tpu_torch.models import core
from qaig_tpu_torch.parallel.sharding import mlp_rule, shard_of

_log = _logging.getLogger("qaig_tpu_torch")


def local_devices(device="cuda"):
    """Every visible card (``device`` ``cuda``), or one CPU device."""
    if torch.device(device).type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


class LocalMesh:
    """A ``(data, model)`` grid of ``torch.device``s in one process:
    ``grid[d][m]``; ``shape`` {"data": n_data, "model": n_model}.  Uses
    the first ``n_data * n_model`` of ``devices`` (every visible card by
    default), as ``qaig_tpu``'s ``make_mesh`` does, and raises when there
    are fewer."""

    def __init__(self, n_data=None, n_model=1, devices=None):
        devices = [torch.device(d) for d in (devices or local_devices())]
        n = len(devices)
        if n_data is None:
            n_data = n // n_model
        use = n_data * n_model
        if n_data < 1 or n_model < 1 or use > n:
            raise ValueError(f"Mesh {n_data}x{n_model} needs {use} devices, "
                             f"have {n}.")
        self.shape = {"data": n_data, "model": n_model}
        self.grid = [devices[d * n_model:(d + 1) * n_model]
                     for d in range(n_data)]

    def size(self, axis):
        return self.shape[axis]

    def batch_blocks(self, n):
        """Row ranges ``[start, stop)`` of each data replica's block of a
        leading axis of ``n`` rows: contiguous blocks of ``n / n_data``."""
        n_data = self.size("data")
        if n % n_data:
            raise ValueError(f"batch {n} is not a multiple of the mesh's "
                             f"data axis ({n_data})")
        k = n // n_data
        return [(d * k, (d + 1) * k) for d in range(n_data)]

    def describe(self):
        return f"data={self.size('data')} x model={self.size('model')}"


def local_mesh_for_batch(batch_size, n_model=1, devices=None):
    """A :class:`LocalMesh` whose data axis is the largest divisor of
    ``batch_size`` that fits ``len(devices) // n_model`` (every visible
    card by default), as ``qaig_tpu``'s ``make_mesh_for_batch`` builds
    it.  Devices left over are logged with ``qaig_tpu``'s warning; one
    process drives them all, so they idle and nothing fails."""
    devices = [torch.device(d) for d in (devices or local_devices())]
    cap = max(len(devices) // n_model, 1)
    n_data = max(d for d in range(1, cap + 1) if batch_size % d == 0)
    used = n_data * n_model
    if used < len(devices):
        _log.warning(
            "Mesh %s uses %d of %d devices (%s %d not divisible by "
            "more); %d chips idle — pad the %s to a multiple of %d to "
            "use them all.", f"{n_data}x{n_model}", used, len(devices),
            "batch", batch_size, len(devices) - used, "batch", cap)
    return LocalMesh(n_data=n_data, n_model=n_model, devices=devices)


class LocalShards:
    """A tensor-parallel MLP's link to its other shards in this process:
    ``parts[i]`` is shard ``i + 1`` (an ``MLP2``, or its packed QKV) on
    ``devices[i]``; shard 0 is the module that holds the link, on the home
    card."""

    def __init__(self, parts, devices):
        self.parts, self.devices = list(parts), list(devices)

    def sum_partials(self, fn, part, x):
        """``fn(part, x)`` (shard 0's partial product) plus every other
        shard's ``fn`` on a copy of ``x`` on its card, each brought back
        to the home card and added in shard order."""
        y = fn(part, x)
        for other, device in zip(self.parts, self.devices):
            y = y + fn(other, x.to(device, non_blocking=True)).to(y.device)
        return y

    def zip(self, fn, *links):
        """The link of a structure built from several MLPs' shards (the
        packed QKV: ``fn(q, k, v)`` of each shard's three MLPs), each
        shard's built on its own card."""
        parts = zip(self.parts, *(link.parts for link in links))
        return LocalShards([fn(*group) for group in parts], self.devices)

    def __deepcopy__(self, memo):
        return self


def shard_mlps_local_(module, devices):
    """Megatron TP over the cards of one process: every 2-layer MLP of
    ``module`` (on ``devices[0]``) keeps its shard 0 in place, split as
    ``parallel/sharding.py::mlp_rule`` splits it (``l0``'s rows, ``l1``'s
    columns; ``l1.bias`` whole), and a :class:`LocalShards` link holds
    shard ``i`` on ``devices[i]``.  A no-op on one device."""
    n = len(devices)
    if n == 1:
        return module
    for m in module.modules():
        if not isinstance(m, core.MLP2):
            continue
        if m.l0.weight.shape[0] % n:
            raise ValueError(f"hidden_dim {m.l0.weight.shape[0]} not "
                             f"divisible by --num-model-shards {n}")
        with torch.no_grad():
            full = {name: p.detach() for name, p in m.named_parameters()}
            others = []
            for i, device in enumerate(devices[1:], start=1):
                shard = copy.deepcopy(m)
                for name, p in shard.named_parameters():
                    dim = mlp_rule("." + name)
                    if dim is not None:
                        p.data = shard_of(full[name], dim, n, i)
                others.append(shard.to(device))
            for name, p in m.named_parameters():
                dim = mlp_rule("." + name)
                if dim is not None:
                    p.data = shard_of(p.data, dim, n, 0)
        m.tp = LocalShards(others, devices[1:])
    return module
