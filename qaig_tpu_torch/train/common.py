"""Loaders shared by the stages (the generation half of
``qaig_tpu/train/common.py``): config load, device selection, dtype casts,
flat-state restore, and rebuilding the FC decoder and codebooks from their
checkpoints.
"""

import json
import os

import torch

from qaig_tpu_torch.convert import load_jax_state
from qaig_tpu_torch.models import core


def load_config(path):
    with open(path, "r") as f:
        return json.load(f)


def select_device(device):
    """The CLI ``--device`` flag as a ``torch.device``.  ``cuda`` (the
    default of the entry points) requires a visible GPU and never falls
    back to the CPU."""
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
