"""Plumbing shared by the stages (counterpart of
``qaig_tpu/train/common.py``): config load, device selection (TF32 off),
dtype casts, checkpoint load, flat-state and optimizer-state restore,
rebuilding the FC decoder, the autoencoder and codebooks from their
checkpoints, checkpoint discovery and retention (pickle checkpoints only),
throughput and metrics logs, a ``torch.profiler`` window, and the NaN
guard.  Model and optimizer states cross to and from ``qaig_tpu``'s
checkpoint schema through ``qaig_tpu_torch.convert``.
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
from qaig_tpu_torch.utils.checkpoint import load_model


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
    """Tolerantly restore a checkpoint's flat ``qaig_tpu`` state into
    ``model`` in place (layouts converted by ``qaig_tpu_torch.convert``).
    Reference torch state dicts are not read by the port."""
    if looks_like_torch_state(state):
        raise ValueError("reference torch state dicts are not supported by "
                         "the port; convert the checkpoint with qaig_tpu "
                         "first")
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
    state and put ``scheduler`` at its update count; a state that does
    not fit is logged and the optimizer stays fresh."""
    from qaig_tpu_torch.train import optim
    try:
        count = load_optax_state(model, optimizer, state, logging=logging)
    except Exception as e:
        logging(f"Could not restore optimizer state: {e}")
        return
    optim.set_update_count(optimizer, scheduler, count)


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
    for n, path in _list_checkpoints(out_dir, prefix):
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
    for _, path in _list_checkpoints(out_dir, prefix)[keep:]:
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

    def __init__(self, out_dir):
        self.path = os.path.join(str(out_dir), "metrics.jsonl")
        self._fh = open(self.path, "a")

    def log(self, **fields):
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
