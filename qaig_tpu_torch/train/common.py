"""Plumbing shared by the stages (counterpart of
``qaig_tpu/train/common.py``): config load, device selection (TF32 off),
dtype casts, checkpoint load, flat-state and optimizer-state restore,
rebuilding the FC decoder, the autoencoder and codebooks from their
checkpoints, checkpoint discovery and retention (pickle checkpoints only),
throughput and metrics logs, a ``torch.profiler`` window, and the NaN
guard, and the multi-process runtime (``--multihost``; the process group
and its collectives are ``qaig_tpu_torch/parallel/comm.py``'s).  Model and
optimizer states cross to and from ``qaig_tpu``'s
checkpoint schema through ``qaig_tpu_torch.convert``; reference torch
state dicts and Adam states are read through ``utils/torch_compat.py``
and ``utils/torch_optim.py``.
"""

import json
import os
import re
import time
from pathlib import Path

import numpy as np
import torch

from qaig_tpu_torch.convert import load_jax_state, load_optax_state
from qaig_tpu_torch.models import core
from qaig_tpu_torch.utils import spans, torch_compat, torch_optim
from qaig_tpu_torch.parallel import comm
from qaig_tpu_torch.utils.checkpoint import (host_snapshot, load_model,
                                             pending_paths)


def load_config(path):
    with open(path, "r") as f:
        return json.load(f)


def full_float32():
    """Float32 on the card is float32: no TF32 in matmuls or in cuDNN's
    convolutions (PyTorch's default lets cuDNN use it), as ``qaig_tpu``
    computes float32 on the CPU.  bf16 paths are unaffected."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def select_device(device):
    """The CLI ``--device`` flag as a ``torch.device``.  ``cuda`` (the
    default of the entry points) requires a visible GPU and never falls
    back to the CPU.  Every entry point comes through here, so it also
    turns TF32 off (:func:`full_float32`)."""
    full_float32()
    device = torch.device(device or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is visible "
                           "(pass --device cpu to run on the CPU)")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def maybe_init_distributed(args, device, logging=print):
    """``--multihost``: join the run's process group (``parallel/comm.py``:
    ``--coordinator-address`` / ``--num-processes`` / ``--process-id``, or
    torchrun's environment); returns the device this process runs on.
    Without ``--multihost`` the run is single-process."""
    return comm.init(args, device, logging=logging)


def is_main_process():
    """Rank 0 (or a single-process run): the one that writes metrics,
    logs, previews, images and checkpoints."""
    return comm.is_main_process()


def gather_replicated(tensor, mesh):
    """The global batch of a tensor whose rows are split over ``mesh``'s
    data axis, on the host of every rank (collective; one rank: the tensor
    on the host)."""
    return torch.cat(comm.host_all_gather(tensor, mesh.group("data"),
                                          mesh.size("data")))


def single_writer_barrier():
    """The barrier of the single-writer stages (fmap, prune): every rank
    returns only after rank 0's writes are done.  Rank 0 reaches it from a
    ``finally``, so a failing writer releases the others (they return;
    checks of the files show the failure).  No-op single-process."""
    comm.barrier()


def cast_floats(module, dtype):
    """Cast every floating parameter of ``module`` to ``dtype`` in place
    (mixed-precision compute casts)."""
    return module.to(dtype)


def ensure_dir(path):
    os.makedirs(str(path), exist_ok=True)
    return path


def looks_like_torch_state(state):
    return any(k.endswith(".weight") or k.endswith(".bias") or k == "weight"
               for k in state)


def restore_model_state(model, state, logging=print, key_map=None):
    """Tolerantly restore a checkpoint's model entry into ``model`` in
    place: ``qaig_tpu``'s flat state (layouts converted by
    ``qaig_tpu_torch.convert``) or a reference torch state dict
    (``utils/torch_compat.py``).  ``key_map`` applies to the flat state
    only; a reference state dict carries its own prefix rules."""
    if looks_like_torch_state(state):
        return torch_compat.load_torch_into(model, state, logging=logging)
    return load_jax_state(model, state, key_map=key_map, logging=logging)


def load_checkpoint(path, what, log):
    """A checkpoint dict, or RuntimeError naming ``what``."""
    status, ckpt = load_model(path, logging=log.info)
    if not status:
        raise RuntimeError(f"An error occured while loading {what} "
                           "checkpoint!")
    return ckpt


def restore_optimizer(model, optimizer, scheduler, state, logging=print):
    """Fill ``optimizer`` (Adam over ``model``) from a ``qaig_tpu`` optax
    state or a reference torch Adam state and put ``scheduler`` at its
    update count; a state that does not fit is logged and the optimizer
    stays fresh.  Only the per-parameter state is written: the group
    settings (``capturable``, the learning-rate tensor) stay the port's."""
    from qaig_tpu_torch.train import optim
    try:
        if torch_optim.is_torch_adam_state(state):
            count = torch_optim.import_adam_state(model, optimizer, state,
                                                  logging=logging)
        else:
            count = load_optax_state(model, optimizer, state,
                                     logging=logging)
    except Exception as e:
        logging(f"Could not restore optimizer state: {e}")
        return
    optim.set_update_count(optimizer, scheduler, count)


def use_graphs(graphed, device, debug_nans=False):
    """Whether a trainer's step replays from a CUDA graph: ``graphed``
    when given, else on CUDA, where ``--debug-nans`` (autograd's anomaly
    mode, which cannot run inside a capture) runs the eager step instead.
    On the CPU the step is eager."""
    device = torch.device(device)
    if graphed is None:
        return (device.type == "cuda" and not debug_nans
                and comm.graphs_allowed())
    if graphed and device.type != "cuda":
        raise ValueError("a train step runs as a CUDA graph on CUDA only")
    if graphed and debug_nans:
        raise ValueError("--debug-nans runs the eager step: anomaly "
                         "detection cannot run inside a CUDA graph capture")
    if graphed and not comm.graphs_allowed():
        raise ValueError("gloo's collectives (ranks sharing a card) cannot "
                         "be captured in a CUDA graph")
    return bool(graphed)


def train_step_mode(device, debug_nans=False):
    """The log line of a trainer's step mode, with its reason when a step
    on CUDA runs eagerly."""
    if use_graphs(None, device, debug_nans):
        return "Train step: CUDA graph"
    if torch.device(device).type == "cuda" and not comm.graphs_allowed():
        return ("Train step: eager (gloo's collectives cannot be captured "
                "in a CUDA graph)")
    return "Train step: eager"


def graph_train_step(device_step, warmup, optimizer, device):
    """``device_step(*tensors) -> loss`` (one update of the parameters,
    optimizer state and EMA in place) replayed from a CUDA graph captured
    at the first call of each shape and dtype of its inputs (the
    counterpart of the JAX trainers' one jitted program per step).  The
    inputs are copied into the graph's static buffers; the parameters,
    their gradients (allocated by the capture, then rewritten in place by
    every replay) and the optimizer's state keep their addresses.  Before
    a capture the optimizer's state is created (``optim.init_adam_state``)
    and ``warmup(*static inputs)`` runs the step's forward and backward
    once, updating nothing, on the capture's stream: cuBLAS and cuDNN set
    up in the capturing thread and in autograd's device thread there.  A
    capture that fails raises.  The returned function's ``runner`` holds
    the graphs (``infer/graphs.py::GraphRunner``)."""
    from qaig_tpu_torch.infer.graphs import GraphRunner
    from qaig_tpu_torch.train import optim
    runner = GraphRunner(device)

    def run(*inputs):
        key = tuple((tuple(x.shape), x.dtype) for x in inputs)
        if key not in runner.graphs:
            optim.init_adam_state(optimizer)
        return runner(key, device_step, inputs, prepare=warmup)

    run.runner = runner
    return run


def train_step(forward_backward, update, optimizer, scheduler, device,
               graphed=None, debug_nans=False):
    """A trainer's step over tensor inputs: zero the gradients,
    ``forward_backward(*inputs) -> loss`` (detached), ``update()`` (the
    optimizer's step and what goes with it), then, outside the device
    work, ``scheduler.step()``.  The device work replays from a CUDA graph
    when :func:`use_graphs` says so (:func:`graph_train_step`), else runs
    eagerly, under autograd's anomaly mode with ``debug_nans``.  Returns
    ``step(*inputs) -> loss``; its ``runner`` holds the graphs (None when
    eager)."""
    graphed = use_graphs(graphed, device, debug_nans)

    def device_step(*inputs):
        optimizer.zero_grad(set_to_none=True)
        loss = forward_backward(*inputs)
        update()
        return loss

    def warmup(*inputs):
        forward_backward(*inputs)
        optimizer.zero_grad(set_to_none=True)

    replay = (graph_train_step(device_step, warmup, optimizer, device)
              if graphed else None)

    def step(*inputs):
        if replay is not None:
            loss = replay(*inputs)
        else:
            with torch.autograd.set_detect_anomaly(debug_nans):
                loss = device_step(*(x.to(device) for x in inputs))
        if scheduler is not None:
            with spans.span("train.scheduler"):
                scheduler.step()
        return loss

    step.runner = None if replay is None else replay.runner
    return step


def parallel_update(optimizer, parallel=None):
    """A stage trainer's update: ``optimizer.step()``, with ``parallel``
    (``parallel/sharding.py::Parallel``) between the gradients' reduction
    over the mesh and ZeRO's all-gather of the parameters."""
    if parallel is None:
        return optimizer.step

    def update():
        parallel.reduce_grads_()
        optimizer.step()
        parallel.after_step_()
    return update


def gather_training_state(model, optimizer=None, parallel=None,
                          snapshot=False):
    """(parameters, Adam states) by torch name for a checkpoint of
    ``model``, as the converters' ``params=`` / ``states=`` take them:
    under ``parallel`` the full tensors (collective: every rank calls it);
    with ``snapshot`` host copies for a background write
    (``utils/checkpoint.py::host_snapshot``); else (None, None), and the
    converters read the model and its optimizer directly.  No optimizer:
    states None."""
    if parallel is not None:
        params = parallel.full_params(model)
        states = parallel.full_states() if optimizer is not None else None
    elif snapshot:
        params = dict(model.named_parameters())
        states = None if optimizer is None else {
            name: optimizer.state[p] for name, p in params.items()
            if p in optimizer.state}
    else:
        return None, None
    return host_snapshot((params, states)) if snapshot else (params, states)


def submodule_key_map(keep_prefix, drop_prefixes=()):
    """Extract one submodule from a composite flat checkpoint: strip
    ``keep_prefix`` from matching paths, drop ``drop_prefixes`` paths, pass
    everything else through."""
    def key_map(name):
        if name.startswith(keep_prefix):
            return name[len(keep_prefix):]
        for drop in drop_prefixes:
            if name.startswith(drop):
                return None
        return name
    return key_map


def init_for_restore(module, device):
    """Default-initialized parameters (seed 0) for anything a checkpoint
    does not cover, as ``qaig_tpu`` restores onto ``init(PRNGKey(0))``."""
    core.init_parameters(module, torch.Generator(device=device).manual_seed(0))
    return module.requires_grad_(False)


def decoder_from_checkpoint(ckpt, device, logging=print):
    """Rebuild the FC decoder from an autoencoder checkpoint dict."""
    from qaig_tpu_torch.models.conv_nets import ConvNetConfig, FCDecoder
    cfg = ConvNetConfig(
        num_layers=ckpt["num_layers"],
        image_channel=ckpt["image_channel"],
        min_channel=ckpt["min_channel"],
        max_channel=ckpt["max_channel"],
        latent_channel=ckpt["latent_channel"],
        hidden_activation_type=ckpt["hidden_activation_type"],
        use_final_activation=ckpt["use_final_dec_activation"],
        final_activation_type=ckpt["decoder_activation_type"])
    model = init_for_restore(FCDecoder(cfg, device=device), device)
    restore_model_state(model, ckpt["model"], logging=logging,
                        key_map=submodule_key_map(
                            "fc_decoder.", drop_prefixes=("fc_encoder.",)))
    return model, cfg


def autoencoder_config(ckpt):
    """The ``AutoencoderConfig`` a checkpoint describes."""
    from qaig_tpu_torch.models.conv_nets import AutoencoderConfig
    return AutoencoderConfig(**{
        key: ckpt[key] for key in (
            "num_layers", "image_channel", "min_channel", "max_channel",
            "latent_channel", "hidden_activation_type",
            "use_final_enc_activation", "encoder_activation_type",
            "use_final_dec_activation", "decoder_activation_type")})


def autoencoder_from_checkpoint(ckpt, device, logging=print):
    """Rebuild the whole autoencoder from its checkpoint dict."""
    from qaig_tpu_torch.models.conv_nets import Autoencoder
    cfg = autoencoder_config(ckpt)
    model = init_for_restore(Autoencoder(cfg, device=device), device)
    restore_model_state(model, ckpt["model"], logging=logging)
    return model, cfg


def codebook_from_checkpoint(ckpt, device, logging=print):
    """Rebuild a codebook from its checkpoint dict."""
    from qaig_tpu_torch.models.codebook import Codebook
    model = init_for_restore(Codebook(
        patch_dim=tuple(ckpt["patch_dim"]),
        image_dim=tuple(ckpt["image_dim"]),
        image_channel=ckpt["image_C"],
        num_embeddings=ckpt["num_embeddings"],
        init_neighbour_range=ckpt["neighbourhood_range"],
        device=device), device)
    restore_model_state(model, ckpt["checkpoint"], logging=logging)
    return model


def _checkpoint_complete(path):
    """Pickle checkpoints are written atomically (tmp + rename), so a
    non-empty file is complete."""
    return os.path.isfile(path) and os.path.getsize(path) > 0


def _list_checkpoints(out_dir, prefix):
    """Every ``<prefix>_<N>.pt`` under ``<out_dir>/models_checkpoint`` as
    ``(N, path)``, newest first: the one naming contract that discovery
    and retention share."""
    folder = Path(out_dir) / "models_checkpoint"
    if not folder.is_dir():
        return []
    pattern = re.compile(rf"{re.escape(prefix)}_(\d+)\.pt")
    return sorted(((int(m.group(1)), p) for p in folder.iterdir()
                   if (m := pattern.fullmatch(p.name))), reverse=True)


def find_latest_checkpoint(out_dir, prefix="model", logging=None):
    """Newest complete ``<prefix>_<N>.pt`` under
    ``<out_dir>/models_checkpoint`` as ``(path, N)``, or ``(None, -1)``
    (``--auto-resume``).  An incomplete file is skipped for the one
    before it."""
    pending = pending_paths()
    for n, path in _list_checkpoints(out_dir, prefix):
        if str(path) in pending:
            continue
        if _checkpoint_complete(path):
            return path, n
        if logging is not None:
            logging(f"Auto-resume: skipping incomplete checkpoint {path} "
                    "(interrupted write).")
    return None, -1


def prune_checkpoints(out_dir, keep, prefix="model", logging=None):
    """Delete all but the ``keep`` newest ``<prefix>_<N>.pt`` checkpoints
    (``--keep-checkpoints``; call only after a successful save)."""
    if not keep or keep < 1:
        return
    pending = pending_paths()
    written = [(n, path) for n, path in _list_checkpoints(out_dir, prefix)
               if str(path) not in pending]
    for _, path in written[keep:]:
        try:
            path.unlink()
            if logging is not None:
                logging(f"Pruned old checkpoint {path.name} "
                        f"(--keep-checkpoints {keep}).")
        except OSError as e:
            if logging is not None:
                logging(f"Could not prune {path}: {e}")


class ThroughputMeter:
    """Samples/s between metric syncs (each sync reads the loss, which
    waits for the device, so the wall-clock deltas are honest).  The
    first call returns None."""

    def __init__(self, batch_size):
        self.batch_size = batch_size
        self._last_step = None
        self._last_t = None

    def rate(self, step):
        now = time.monotonic()
        prev_step, prev_t = self._last_step, self._last_t
        self._last_step, self._last_t = step, now
        if prev_step is None or step <= prev_step or now <= prev_t:
            return None
        return round((step - prev_step) * self.batch_size / (now - prev_t),
                     2)


class MetricsLogger:
    """Append-only JSONL metrics stream (``<out>/metrics.jsonl``)."""

    def __init__(self, out_dir, enabled=True):
        self.path = os.path.join(str(out_dir), "metrics.jsonl")
        self._fh = open(self.path, "a") if enabled else None

    def log(self, **fields):
        if self._fh is None:
            return
        self._fh.write(json.dumps(fields) + "\n")
        self._fh.flush()

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None


class Profiler:
    """``torch.profiler`` trace of train steps [start, start + steps)
    (``--profile-dir d [--profile-start s --profile-steps n]``), written
    as a Chrome trace ``d/trace_<start>.json``."""

    def __init__(self, args):
        self.dir = args.get("profile_dir")
        self.start = args.get("profile_start", 5)
        self.steps = args.get("profile_steps", 5)
        self._prof = None

    def step(self, global_step):
        if not self.dir:
            return
        if global_step == self.start and self._prof is None:
            from torch.profiler import ProfilerActivity, profile
            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities)
            self._prof.__enter__()
        elif self._prof is not None \
                and global_step >= self.start + self.steps:
            self.close()

    def close(self):
        if self._prof is None:
            return
        self._prof.__exit__(None, None, None)
        os.makedirs(str(self.dir), exist_ok=True)
        self._prof.export_chrome_trace(
            os.path.join(str(self.dir), f"trace_{self.start}.json"))
        self._prof = None


def check_finite(loss, context="training"):
    if not np.isfinite(loss):
        raise FloatingPointError(f"NaN encountered during {context}.")
