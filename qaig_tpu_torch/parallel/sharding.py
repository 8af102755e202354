"""Megatron tensor parallelism, ZeRO-1 and the gradient reduction of the
parallel training forms (counterpart of ``qaig_tpu/parallel/sharding.py``,
whose collectives XLA inserts from sharding annotations; here they are
explicit).

TP (``--num-model-shards``): every 2-layer MLP of the transformer (Q/K/V,
FFN, pos-cond MLP, classifier) keeps its rank's shard: ``l0`` split by
output rows (JAX ``l0.w`` is (in, hidden) with ``P(None, "model")``, torch
``l0.weight`` is (hidden, in) split on dim 0; ``l0.bias`` split), ``l1``
by input columns (JAX ``P("model", None)``, torch ``l1.weight`` split on
dim 1); ``l1.bias`` stays whole and is added once, after the all-reduce
(``models/core.py::mlp2``, ``models/blocks.py::packed_qkv``).  Everything
else is replicated; the autoencoder and the codebooks have no such MLP and
stay replicated.

DP: the gradients are averaged over the data group by one all-reduce of
one flat buffer inside the step (no DDP), so the collective lands in the
step's CUDA graph.  ZeRO-1 (``--zero-opt``): each parameter's Adam moments
are split on its largest free dimension that divides the data axis, as
``qaig_tpu``'s :func:`zero_opt_spec` splits them, so a rank holds the
slice its JAX device holds; the gradients are reduce-scattered (mean), a
capturable Adam updates this rank's slices (one flat master tensor) and
the parameters are all-gathered.  A parameter with no such dimension keeps
full moments.  Under PP the replicated parts' gradients (embeddings,
encoder, pos-cond, classifier) are summed over the pipe group first: each
stage holds its part of them.
"""

from collections import defaultdict

import torch

from qaig_tpu_torch.convert import adam_entry, mapping
from qaig_tpu_torch.models import core
from qaig_tpu_torch.parallel import comm


def mlp_rule(name):
    """The dimension of the torch parameter ``name`` that TP splits over
    the model axis, or None (replicated)."""
    if name.endswith((".l0.weight", ".l0.bias")):
        return 0
    if name.endswith(".l1.weight"):
        return 1
    return None


def shard_mlps_(module, mesh):
    """Keep only this rank's TP shard of every 2-layer MLP of ``module``
    (in place: the parameters keep their identity) and link the MLPs to the
    model group.  A no-op on a model axis of 1."""
    n, i = mesh.size("model"), mesh.index("model")
    if n == 1:
        return module
    link = comm.ModelShards(mesh.group("model"))
    for m in module.modules():
        if isinstance(m, core.MLP2):
            if m.l0.weight.shape[0] % n:
                raise ValueError(f"hidden_dim {m.l0.weight.shape[0]} not "
                                 f"divisible by --num-model-shards {n}")
            m.tp = link
    with torch.no_grad():
        for name, p in module.named_parameters():
            dim = mlp_rule(name)
            if dim is not None:
                p.data = shard_of(p.data, dim, n, i)
    return module


def shard_of(tensor, dim, n, i):
    """Slice ``i`` of ``n`` equal slices of ``tensor`` on ``dim`` (a
    copy)."""
    k = tensor.shape[dim] // n
    return tensor.narrow(dim, i * k, k).clone()


def _jax_order(kind, ndim):
    """The torch dimensions of a parameter in its JAX layout's order
    (``convert``'s layouts), so that ties break as ``qaig_tpu``'s do."""
    return {"linear": [1, 0], "conv": [2, 3, 1, 0],
            "convT": [2, 3, 0, 1]}.get(kind, list(range(ndim)))


def zero_opt_spec(module, param_spec, n_data):
    """{parameter name: the dimension ZeRO-1 splits its moments on over
    the data axis, or None (full moments)}: the largest dimension that TP
    does not split and whose size divides ``n_data`` (ties: the first in
    JAX's layout)."""
    kinds = {torch_name: kind
             for torch_name, kind in mapping(module).values()}
    out = {}
    for name, p in module.named_parameters():
        order = _jax_order(kinds.get(name, "plain"), p.ndim)
        free = [d for d in order if d != param_spec.get(name)]
        free.sort(key=lambda d: -p.shape[d])
        out[name] = next((d for d in free if p.shape[d] % n_data == 0),
                         None)
    return out


class _ZeroSlot:
    """A parameter's place in the ZeRO flat buffers: its split dimension,
    the numel of one rank's slice and its offset in a rank's segment."""

    def __init__(self, param, dim, n, offset):
        self.param, self.dim, self.n, self.offset = param, dim, n, offset
        self.numel = param.numel() // n

    def rows(self, tensor):
        """``tensor`` (the parameter's shape) as (n, numel): row r is rank
        r's slice."""
        return tensor.movedim(self.dim, 0).reshape(self.n, self.numel)

    def unrows(self, rows):
        """Inverse of :meth:`rows` (a new tensor of the parameter's
        shape)."""
        moved = list(self.param.shape)
        moved.insert(0, moved.pop(self.dim))
        return rows.reshape(moved).movedim(0, self.dim).contiguous()


class Parallel:
    """The parallel forms of one model's training on ``mesh``: applies TP
    (``tensor_parallel``) and the pipeline's layer split (``pipeline``, a
    :class:`qaig_tpu_torch.parallel.pipeline.GPipe`) to ``model`` and to
    ``ema_model``, and moves ``optimizer`` (a ``torch.optim.Adam`` over
    ``model``'s parameters, state restored or fresh; its schedule and
    learning-rate tensor stay) onto this rank's parameters, or with
    ``zero`` onto one flat master tensor of this rank's ZeRO slices plus
    the parameters that keep full moments.  The step calls
    :meth:`zero_grad_`, :meth:`reduce_grads_`, optionally
    :meth:`clip_grads_`, the optimizer's ``step()``, then
    :meth:`after_step_`; checkpoints read :meth:`full_params` and
    :meth:`full_states`."""

    def __init__(self, model, optimizer, mesh, zero=False, pipeline=None,
                 ema_model=None, tensor_parallel=True):
        self.mesh, self.optimizer, self.pipe = mesh, optimizer, pipeline
        group, = optimizer.param_groups
        trained = {id(p) for p in group["params"]}
        names = {id(p): name for name, p in model.named_parameters()}
        old = {names[i]: dict(optimizer.state.get(p, {}))
               for p in group["params"] if (i := id(p)) in names}
        n_model = mesh.size("model") if tensor_parallel else 1
        self.tp_dim = {}
        if n_model > 1:
            shard_mlps_(model, mesh)
            if ema_model is not None:
                shard_mlps_(ema_model, mesh)
            self.tp_dim = {name: mlp_rule(name) for name in names.values()}
            for name, st in old.items():
                if self.tp_dim.get(name) is not None:
                    for key in ("exp_avg", "exp_avg_sq"):
                        if key in st:
                            st[key] = shard_of(st[key], self.tp_dim[name],
                                               n_model, mesh.index("model"))
        if pipeline is not None:
            pipeline.release_other_layers_(model)
            if ema_model is not None:
                pipeline.release_other_layers_(ema_model)
        self.params = [(name, p) for name, p in model.named_parameters()
                       if id(p) in trained and p.device.type != "meta"]
        n_data = mesh.size("data")
        dims = (zero_opt_spec(model, self.tp_dim, n_data) if zero else {})
        self.slots, full = [], []
        offset = 0
        for name, p in self.params:
            if dims.get(name) is None:
                full.append((name, p))
            else:
                slot = _ZeroSlot(p, dims[name], n_data, offset)
                self.slots.append((name, slot))
                offset += slot.numel
        self.full = full
        self.master = None
        d = mesh.index("data")
        with torch.no_grad():
            if self.slots:
                device = self.params[0][1].device
                self.master = torch.nn.Parameter(torch.cat(
                    [s.rows(s.param.detach())[d] for _, s in self.slots]))
                self.shard_grad = torch.zeros_like(self.master)
                self.send = torch.zeros(n_data * offset, device=device)
                self.gathered = torch.zeros(n_data * offset, device=device)
        group["params"] = ([self.master] if self.master is not None
                           else []) + [p for _, p in full]
        optimizer.state = defaultdict(dict)
        counts = [int(st["step"]) for st in old.values() if "step" in st]
        if counts:
            count = max(counts)
            for name, p in full:
                st = old.get(name, {})
                optimizer.state[p] = adam_entry(
                    optimizer, p, count,
                    st.get("exp_avg", torch.zeros_like(p)),
                    st.get("exp_avg_sq", torch.zeros_like(p)))
            if self.master is not None:
                moments = []
                for key in ("exp_avg", "exp_avg_sq"):
                    moments.append(torch.cat([
                        s.rows(old.get(name, {}).get(
                            key, torch.zeros_like(s.param)))[d]
                        for name, s in self.slots]))
                optimizer.state[self.master] = adam_entry(
                    optimizer, self.master, count, *moments)

    # -- the step ------------------------------------------------------------

    def owned(self, module):
        """``module``'s parameters that this rank holds (not the pipeline
        stages' other layers)."""
        return [p for p in module.parameters() if p.device.type != "meta"]

    def zero_grad_(self):
        for _, p in self.params:
            p.grad = None

    def _grad(self, p):
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        return p.grad

    def reduce_grads_(self):
        """Sum the replicated parts' gradients over the pipe group, then
        average over the data group: reduce-scatter the ZeRO slices into
        the master's gradient, all-reduce the rest."""
        mesh = self.mesh
        if self.pipe is not None:
            comm.all_reduce_sum_(
                [self._grad(p) for name, p in self.params
                 if not name.startswith("decoder_layers.")],
                mesh.group("pipe"))
        n = mesh.size("data")
        if self.slots:
            rows = self.send.view(n, -1)
            for _, s in self.slots:
                rows[:, s.offset:s.offset + s.numel] = s.rows(
                    self._grad(s.param))
                s.param.grad = None
            self.master.grad = self.shard_grad
            comm.reduce_scatter_mean_(self.shard_grad, self.send,
                                      mesh.group("data"), n)
        comm.all_reduce_mean_([self._grad(p) for _, p in self.full],
                              mesh.group("data"), n)

    def _replicas(self, name, zero_slice=False):
        """How many ranks hold the same values as this rank's gradient of
        ``name`` (its ZeRO slice with ``zero_slice``)."""
        split = 1
        if self.tp_dim.get(name) is not None:
            split *= self.mesh.size("model")
        if self.pipe is not None and name.startswith("decoder_layers."):
            split *= self.mesh.size("pipe")
        if zero_slice:
            split *= self.mesh.size("data")
        return comm.world_size() // split

    def clip_grads_(self, max_norm):
        """Scale the reduced gradients to ``max_norm`` global norm at
        most: each rank sums the squares it holds, each over the number of
        ranks holding the same values, and the sums are all-reduced."""
        terms, grads = [], []
        for name, p in self.full:
            terms.append(p.grad.square().sum() / self._replicas(name))
            grads.append(p.grad)
        if self.master is not None:
            for name, s in self.slots:
                piece = self.master.grad[s.offset:s.offset + s.numel]
                terms.append(piece.square().sum()
                             / self._replicas(name, zero_slice=True))
            grads.append(self.master.grad)
        total = torch.stack(terms).sum()
        if comm.active():   # over every rank (warmed by make_mesh)
            torch.distributed.all_reduce(total)
        scale = torch.clamp(max_norm / torch.clamp(total.sqrt(), min=1e-12),
                            max=1.0)
        for g in grads:
            g.mul_(scale)

    @torch.no_grad()
    def after_step_(self):
        """ZeRO: all-gather the updated slices into every parameter."""
        if self.master is None:
            return
        torch.distributed.all_gather_into_tensor(
            self.gathered, self.master.detach(),
            group=self.mesh.group("data"))
        rows = self.gathered.view(self.mesh.size("data"), -1)
        for _, s in self.slots:
            s.param.copy_(s.unrows(rows[:, s.offset:s.offset + s.numel]))

    def mean_loss(self, loss):
        """The global mean loss on every rank: the pipeline's last stage's
        loss sent to the other stages, averaged over the data group."""
        if self.pipe is not None:
            loss = self.pipe.broadcast_loss(loss)
        n = self.mesh.size("data")
        if n > 1:
            loss = comm.mean_(loss.clone(), self.mesh.group("data"), n)
        return loss

    # -- checkpoints ---------------------------------------------------------

    def _gather(self, local):
        """Full host tensors of every parameter name of the model from
        this rank's ``local`` {name: tensor}: TP shards concatenated over
        the model group, the pipeline stages' layers gathered over the
        pipe group."""
        mesh = self.mesh
        out = {}
        for name, t in local.items():
            dim = self.tp_dim.get(name)
            if dim is not None:
                out[name] = torch.cat(comm.host_all_gather(
                    t, mesh.group("model"), mesh.size("model")), dim=dim)
            else:
                out[name] = t.detach().cpu()
        if self.pipe is not None:
            mine = [n for n in out if n.startswith("decoder_layers.")]
            flat = torch.cat([out[n].reshape(-1) for n in mine])
            pieces = comm.host_all_gather(flat, mesh.group("pipe"),
                                          mesh.size("pipe"))
            for stage, piece in enumerate(pieces):
                for name, value in zip(mine, piece.split(
                        [out[n].numel() for n in mine])):
                    out[self.pipe.rename(name, stage)] = \
                        value.view_as(out[name]).clone()
        return out

    def full_params(self, module):
        """{name: full host tensor} of ``module`` (the model or its EMA
        copy).  Every rank calls it (collectives); every rank gets it."""
        return self._gather({name: p for name, p in module.named_parameters()
                             if p.device.type != "meta"})

    def full_states(self):
        """{name: Adam state with full host moments} of every trained
        parameter (empty before the first update).  Collective."""
        state = self.optimizer.state
        n = self.mesh.size("data")
        local, count = {"exp_avg": {}, "exp_avg_sq": {}}, None
        for name, p in self.full:
            st = state.get(p, {})
            if "step" not in st:
                return {}
            count = st["step"]
            for key in local:
                local[key][name] = st[key]
        if self.master is not None:
            st = state.get(self.master, {})
            if "step" not in st:
                return {}
            count = st["step"]
            for key in local:
                gathered = torch.stack(comm.host_all_gather(
                    st[key], self.mesh.group("data"), n))
                for name, s in self.slots:
                    local[key][name] = s.unrows(
                        gathered[:, s.offset:s.offset + s.numel])
        moments = {key: self._gather(values) for key, values in local.items()}
        step = torch.as_tensor(count).detach().cpu()
        return {name: {"step": step, "exp_avg": moments["exp_avg"][name],
                       "exp_avg_sq": moments["exp_avg_sq"][name]}
                for name in moments["exp_avg"]}
