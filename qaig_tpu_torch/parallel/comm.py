"""The multi-process runtime and the collectives of the port's parallel
forms (counterpart of ``qaig_tpu/train/common.py::maybe_init_distributed``
and of the collectives XLA inserts from ``qaig_tpu/parallel``'s sharding
annotations).

One process drives one card (or, with ``--device cpu``, one CPU rank).
``--multihost`` joins a ``torch.distributed`` process group: with
``--coordinator-address host:port --num-processes N --process-id i`` at
``tcp://host:port`` (or at a ``file://`` path that every process sees),
else from torchrun's environment (``MASTER_ADDR``,
``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``; the card is
``cuda:LOCAL_RANK``).  The backend is NCCL on the card and gloo on the
CPU.  NCCL refuses two ranks on one card, so when ranks of one host share
a card (the only way to run several ranks on a one-card machine) the
group runs gloo over CUDA tensors, and says so in a log line; gloo's
collectives cannot be captured in a CUDA graph, so such a run's steps are
eager.  A run without ``--multihost`` has no process group and runs no
collective.

The collectives take the tensors as they are: a collective the backend
refuses on them raises.  Gathers whose result is written by the host
(checkpoints, generated tokens) run on host copies under gloo.
"""

import datetime
import os
import socket

import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(minutes=10)

# the process's runtime: whether the current run is multi-process (a
# process group may outlive a run that used it), its backend, and whether
# its ranks share a card
_STATE = {"active": False, "backend": None, "shared_card": False,
          "device": None}


def active():
    """True while a ``--multihost`` run is in progress in this process."""
    return _STATE["active"]


def rank():
    return dist.get_rank() if active() else 0


def world_size():
    return dist.get_world_size() if active() else 1


def backend():
    return _STATE["backend"] if active() else None


def shared_card():
    return active() and _STATE["shared_card"]


def graphs_allowed():
    """A train step with collectives can be captured in a CUDA graph only
    when they run on NCCL."""
    return not active() or _STATE["backend"] == "nccl"


def is_main_process():
    return rank() == 0


def _card_key(device):
    """What tells two ranks' cards apart: the host and the card's UUID."""
    if device.type != "cuda":
        return f"{socket.gethostname()}/cpu"
    props = torch.cuda.get_device_properties(device)
    return f"{socket.gethostname()}/{getattr(props, 'uuid', device.index)}"


def init(args, device, logging=print):
    """Join the process group of a ``--multihost`` run (see the module
    docstring); returns the device this process runs on.  Without
    ``--multihost`` the run is single-process (``device`` as given).  A
    process joins once: a later ``--multihost`` run in it reuses the
    group."""
    if not args.get("multihost"):
        _STATE["active"] = False
        return device
    if not dist.is_initialized():
        if args.get("coordinator_address"):
            address = args["coordinator_address"]
            url = address if "://" in address else f"tcp://{address}"
            want_rank = int(args.get("process_id") or 0)
            want_world = int(args.get("num_processes") or 1)
            local = want_rank
        else:   # torchrun's environment
            url = "env://"
            want_rank, want_world = -1, -1
            local = int(os.environ.get("LOCAL_RANK",
                                       os.environ.get("RANK", 0)))
        if device.type == "cuda":
            device = torch.device("cuda", local % torch.cuda.device_count())
            torch.cuda.set_device(device)
        store, r, w = next(dist.rendezvous(url, rank=want_rank,
                                           world_size=want_world,
                                           timeout=TIMEOUT))
        store.set(f"qaig_card/{r}", _card_key(device))
        cards = [store.get(f"qaig_card/{i}").decode() for i in range(w)]
        shared = device.type == "cuda" and len(set(cards)) < len(cards)
        name = "nccl" if device.type == "cuda" and not shared else "gloo"
        dist.init_process_group(name, store=store, rank=r, world_size=w,
                                timeout=TIMEOUT)
        _STATE.update(backend=name, shared_card=shared, device=device)
    elif device.type == "cuda":
        device = _STATE["device"]
        torch.cuda.set_device(device)
    _STATE["active"] = True
    logging(f"Process {rank()} of {world_size()}: {backend()} on {device}")
    if shared_card():
        logging("Ranks share a card (NCCL refuses that): collectives run "
                "on gloo over CUDA tensors")
    return device


def shutdown():
    """Leave the process group, if this process joined one (a later
    ``--multihost`` run joins anew)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _STATE.update(active=False, backend=None, shared_card=False,
                  device=None)


# ---------------------------------------------------------------------------
# collectives over a mesh axis's group (None: a single-process run)
# ---------------------------------------------------------------------------

def _mean_op():
    """How a collective averages: NCCL's ReduceOp.AVG (a scaling kernel
    even at one rank, where a plain in-place sum leaves no node in a CUDA
    graph), or a sum that the caller divides (gloo has no AVG)."""
    if backend() == "nccl":
        return dist.ReduceOp.AVG, False
    return dist.ReduceOp.SUM, True


def all_reduce_mean_(tensors, group, size):
    """Average ``tensors`` in place over ``group``: one all-reduce of one
    flat buffer."""
    if group is None or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    mean_(flat, group, size)
    _unflatten(flat, tensors)


def all_reduce_sum_(tensors, group):
    """Sum ``tensors`` in place over ``group`` (one flat buffer)."""
    if group is None or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    _unflatten(flat, tensors)


def _unflatten(flat, tensors):
    torch._foreach_copy_(tensors, [v.view_as(t) for t, v in zip(
        tensors, flat.split([t.numel() for t in tensors]))])


def mean_(tensor, group, size):
    """All-reduce ``tensor`` in place to its mean over ``group``."""
    op, divide = _mean_op()
    dist.all_reduce(tensor, op=op, group=group)
    if divide:
        tensor.div_(size)
    return tensor


def reduce_scatter_mean_(out, tensor, group, size):
    """This rank's block of the mean of ``tensor`` over ``group``, into
    ``out``."""
    op, divide = _mean_op()
    dist.reduce_scatter_tensor(out, tensor, op=op, group=group)
    if divide:
        out.div_(size)
    return out


def host_all_gather(tensor, group, size):
    """Every rank's ``tensor`` of ``group``, as host tensors in rank order
    (one rank: the tensor itself, on the host)."""
    if group is None or size == 1:
        return [tensor.detach().cpu()]
    src = tensor.detach().contiguous()
    if backend() == "gloo":
        src = src.cpu()
    out = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(out, src, group=group)
    return [o.cpu() for o in out]


def barrier():
    """Every rank of the run waits here (no-op single-process)."""
    if active():
        if backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


class _CopyToShards(torch.autograd.Function):
    """Megatron's "f": identity forward; the gradient is summed over the
    model group (each shard's first linear contributes a part)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromShards(torch.autograd.Function):
    """Megatron's "g": the shards' partial products summed over the model
    group; identity backward."""

    @staticmethod
    def forward(ctx, y, group):
        y = y.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class ModelShards:
    """A tensor-parallel MLP's link to its model group: ``copy`` before
    the first (column-split) linear, ``reduce`` after the second
    (row-split) one.  Shared, not copied, by ``copy.deepcopy`` (the EMA
    copy of a sharded model).  ``sum_partials`` and ``zip`` are the seam
    that ``parallel/local.py::LocalShards`` (the shards of one process's
    cards) shares."""

    def __init__(self, group):
        self.group = group

    def copy(self, x):
        return _CopyToShards.apply(x, self.group)

    def reduce(self, y):
        return _ReduceFromShards.apply(y, self.group)

    def sum_partials(self, fn, part, x):
        """``fn(part, x)``, this rank's shard's partial product, summed
        over the model group."""
        return self.reduce(fn(part, self.copy(x)))

    def zip(self, fn, *links):
        """The link of a structure built from several MLPs' shards (the
        packed QKV): this rank holds its shard of each, so the group's
        link."""
        return self

    def __deepcopy__(self, memo):
        return self
