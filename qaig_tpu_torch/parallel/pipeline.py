"""Pipeline parallelism (GPipe) over the transformer's decoder layers
(counterpart of ``qaig_tpu/parallel/pipeline.py``).

Stage p of the mesh's pipe axis holds decoder layers ``[p*L/P, (p+1)*L/P)``
(the other layers' parameters move to the meta device); the embeddings,
the encoder and the position conditioning are computed on every rank, as
``qaig_tpu`` computes them outside its ``shard_map``, and the classifier on
the last stage, which holds the decoder's output.  The batch splits into M
microbatches; stage p runs microbatch m when stage p-1 has sent it, so the
schedule takes M + P - 1 ticks and at tick t stage p runs microbatch t-p.
Activations move by send/recv over the pipe group, and the backward sends
each microbatch's input gradient the other way (all forwards, then all
backwards: GPipe).  The replicated parts' gradients are then summed over
the pipe group (``sharding.Parallel.reduce_grads_``): the embeddings' part
sits on stage 0, the classifier's on the last stage, the encoder's and the
conditioning's on every stage, so each is counted once.

Checkpoints keep the per-layer-list schema: the stages' layers (and their
Adam moments) are gathered by global layer index
(``sharding.Parallel.full_params`` / ``full_states``).

Not ported: ``qaig_tpu``'s refusal of bf16 PP x TP on the CPU
(``qaig_tpu/train/transformer.py:327-343``), an XLA:CPU toolchain limit
and not one of the method.
"""

import torch
import torch.distributed as dist


def validate(num_layers, n_pipe, global_batch, num_microbatches, n_data):
    """``qaig_tpu``'s ``pipelined_apply`` checks, on the global batch."""
    M = int(num_microbatches)
    if num_layers % n_pipe:
        raise ValueError(
            f"num_dec_layers {num_layers} not divisible by pipe={n_pipe}")
    if global_batch % M:
        raise ValueError(f"batch {global_batch} not divisible by "
                         f"num_microbatches {M}")
    if (global_batch // M) % n_data:
        raise ValueError(
            f"microbatch {global_batch // M} not divisible by the mesh data "
            f"axis {n_data} — lower --num-microbatches or pad the batch")


class GPipe:
    """One rank's stage of the GPipe schedule of ``model``'s decoder stack
    over ``mesh``'s pipe axis with ``num_microbatches`` microbatches.
    Passed as ``Transformer.forward(..., decoder_stack=...)``, it runs the
    forward half of the schedule and returns the decoder's output on the
    last stage (None elsewhere); :meth:`backward` runs the backward half."""

    def __init__(self, model, mesh, num_microbatches):
        from qaig_tpu_torch.parallel import comm
        if comm.shared_card():
            raise ValueError(
                "--num-pipeline-stages: the ranks share a card, so their "
                "collectives run on gloo, whose send/recv cannot take CUDA "
                "tensors (it aborts the process); run one process per card")
        self.mesh = mesh
        self.num_microbatches = int(num_microbatches)
        n_pipe = mesh.size("pipe")
        num_layers = model.cfg.num_dec_layers
        if num_layers % n_pipe:
            raise ValueError(f"num_dec_layers {num_layers} not divisible "
                             f"by pipe={n_pipe}")
        self.per_stage = num_layers // n_pipe
        self.stage = mesh.index("pipe")
        first = self.stage * self.per_stage
        self.layers = range(first, first + self.per_stage)
        ranks = mesh.ranks["pipe"]
        self.group = mesh.group("pipe")
        self.prev = ranks[self.stage - 1] if self.stage > 0 else None
        self.next = ranks[self.stage + 1] if self.stage < n_pipe - 1 \
            else None
        self.last_rank = ranks[-1]
        self.device = None
        self._saved = []

    def release_other_layers_(self, module):
        """Move the decoder layers of the other stages to the meta
        device."""
        for i, layer in enumerate(module.decoder_layers):
            if i not in self.layers:
                layer.to("meta")

    def rename(self, name, stage):
        """This stage's decoder-layer parameter ``name`` as the one at the
        same place in ``stage``."""
        _, index, rest = name.split(".", 2)
        local = int(index) - self.layers.start
        return f"decoder_layers.{stage * self.per_stage + local}.{rest}"

    def __call__(self, model, h, enc_out, cond):
        M = self.num_microbatches
        if h.shape[0] % M:
            raise ValueError(f"batch {h.shape[0]} not divisible by "
                             f"num_microbatches {M}")

        def split(a):
            return [None] * M if a is None else a.chunk(M)

        h_mb, enc_mb, cond_mb = split(h), split(enc_out), split(cond)
        self.device = h.device
        self._saved = []
        for m in range(M):
            if self.prev is None:
                x = h_mb[m]
            else:
                x = torch.empty(h_mb[m].shape, dtype=h.dtype,
                                device=h.device)
                dist.recv(x, src=self.prev, group=self.group)
                x.requires_grad_(torch.is_grad_enabled())
            x_in = x
            for i in self.layers:
                x = model._block(model.decoder_layers[i],
                                 model.dec_block_cfg, x, enc_mb[m],
                                 cond_mb[m])
            if self.next is not None:
                dist.send(x.detach().contiguous(), dst=self.next,
                          group=self.group)
            self._saved.append((x_in, x))
        if self.next is not None:
            return None
        return torch.cat([y for _, y in self._saved])

    def backward(self, loss):
        """The backward half: the last stage from ``loss``, the others
        from the output gradients the next stage sends; then each
        microbatch's input gradient to the previous stage."""
        saved, self._saved = self._saved, []
        if self.next is None:
            loss.backward()
        else:
            grads = []
            for _, y in saved:
                g = torch.empty_like(y)
                dist.recv(g, src=self.next, group=self.group)
                grads.append(g)
            torch.autograd.backward([y for _, y in saved], grads)
        if self.prev is not None:
            for x_in, _ in saved:
                dist.send(x_in.grad.contiguous(), dst=self.prev,
                          group=self.group)

    def broadcast_loss(self, loss):
        """The last stage's loss on every stage."""
        if loss is None:
            loss = torch.zeros((), dtype=torch.float32, device=self.device)
        dist.broadcast(loss, src=self.last_rank, group=self.group)
        return loss


def pipelined_apply(model, x_dec, x_enc=None, pos_cond=None, *, mesh,
                    num_microbatches):
    """Teacher-forced logits of this rank's rows, as ``model(x_dec, x_enc,
    pos_cond)`` gives them, with the decoder stack pipelined over
    ``mesh``'s pipe axis; every stage returns them (the last stage's,
    broadcast).  ``qaig_tpu``'s ``pipelined_apply`` validation applies, on
    the global batch (this rank's rows times the data axis)."""
    validate(model.cfg.num_dec_layers, mesh.size("pipe"),
             x_dec.shape[0] * mesh.size("data"), num_microbatches,
             mesh.size("data"))
    pipe = GPipe(model, mesh, num_microbatches)
    logits = model(x_dec, x_enc=x_enc, pos_cond=pos_cond,
                   decoder_stack=pipe)
    if logits is None:
        logits = torch.empty(
            (x_dec.shape[0], x_dec.shape[1], model.cfg.out_dim),
            dtype=model.dtype, device=x_dec.device)
    dist.broadcast(logits.detach() if logits.requires_grad else logits,
                   src=pipe.last_rank, group=pipe.group)
    return logits
