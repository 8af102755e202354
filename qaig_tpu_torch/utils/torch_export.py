"""Port -> reference (PyTorch) checkpoint export (counterpart of
``qaig_tpu/utils/torch_export.py``).

Writes the port's modules as reference-named, reference-layout torch
``state_dict``s, the same keys and arrays ``qaig_tpu``'s exporter writes,
so the reference's loaders (``torch.load`` + ``custom_load_state_dict``)
read them with nothing skipped.  The port composes through ``qaig_tpu``'s
JAX layout (``convert.to_jax_state``), so it keeps that package's layout
rules (the spatial flip of transposed convolutions among them):

* dense kernel ``(in, out)`` -> Linear ``(out, in)``;
* conv ``HWIO`` -> Conv2d ``OIHW``;
* transposed conv (stored correlation-ready: spatially flipped ``HWIO``)
  -> ConvTranspose2d ``(in, out, kH, kW)`` unflipped;
* LayerNorm ``g``/``b`` -> ``weight``/``bias``; Embedding ``w`` ->
  ``weight``.

The name/layout correspondence is one mapping table
(:func:`mapping_for_model`) in the reference's parameter registration
order.  The weight import (``utils/torch_compat.py``) and the Adam-state
conversions (``utils/torch_optim.py``, whose parameter indices follow
this order) read the same table.
"""

import os

import numpy as np
import torch

from qaig_tpu_torch import convert


# ---------------------------------------------------------------------------
# per-leaf layout transforms between the JAX layout and the reference's
# ---------------------------------------------------------------------------

def to_torch_layout(value, kind):
    v = np.asarray(value, dtype=np.float32)
    if kind == "linear":
        return np.ascontiguousarray(v.T)
    if kind == "conv":
        return np.ascontiguousarray(v.transpose(3, 2, 0, 1))
    if kind == "convT":
        return np.ascontiguousarray(v.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1])
    return np.ascontiguousarray(v)


def from_torch_layout(value, kind):
    """Reference layout -> JAX layout (the inverse of
    :func:`to_torch_layout`)."""
    v = np.asarray(value, dtype=np.float32)
    if kind == "linear":
        return np.ascontiguousarray(v.T)
    if kind == "conv":
        return np.ascontiguousarray(v.transpose(2, 3, 1, 0))
    if kind == "convT":
        return np.ascontiguousarray(v[:, :, ::-1, ::-1].transpose(2, 3, 0, 1))
    return np.ascontiguousarray(v)


# ---------------------------------------------------------------------------
# mapping tables: [(JAX flat path, reference name, kind)] in the
# reference's registration order (its ``model.parameters()`` order)
# ---------------------------------------------------------------------------

def _linear_map(out, ours, theirs):
    out.append((f"{ours}.w", f"{theirs}.weight", "linear"))
    out.append((f"{ours}.b", f"{theirs}.bias", "plain"))


def _conv_map(out, ours, theirs, kind="conv"):
    out.append((f"{ours}.w", f"{theirs}.weight", kind))
    out.append((f"{ours}.b", f"{theirs}.bias", "plain"))


def _mlp2_map(out, ours, theirs):
    _linear_map(out, f"{ours}.l0", f"{theirs}.0.linear_layer.0")
    _linear_map(out, f"{ours}.l1", f"{theirs}.1.linear_layer.0")


def _norm_map(out, ours, theirs, use_adaln):
    if use_adaln:
        _linear_map(out, f"{ours}.scale", f"{theirs}.scale_layer.scale")
        _linear_map(out, f"{ours}.shift", f"{theirs}.shift_layer.shift")
    else:
        out.append((f"{ours}.g", f"{theirs}.weight", "plain"))
        out.append((f"{ours}.b", f"{theirs}.bias", "plain"))


def _res_map(out, ours, theirs, use_scale):
    if use_scale:
        # the reference's ResidualLinearLayer registers scale_layer first
        _linear_map(out, f"{ours}.scale", f"{theirs}.scale_layer.scale")
    _linear_map(out, f"{ours}.linear", f"{theirs}.linear.linear_layer.0")


def _attn_map(out, ours, theirs):
    for o, t in (("q", "q_block"), ("k", "k_block"), ("v", "v_block")):
        _mlp2_map(out, f"{ours}.{o}", f"{theirs}.{t}")


def _block_map(out, ours, theirs, use_cross, use_adaln, use_scale):
    _norm_map(out, f"{ours}.self_attn.norm",
              f"{theirs}.self_attn_block.self_attn_norm", use_adaln)
    _attn_map(out, f"{ours}.self_attn.attn",
              f"{theirs}.self_attn_block.self_attn")
    _res_map(out, f"{ours}.self_attn.res",
             f"{theirs}.self_attn_block.self_attn_res", use_scale)
    if use_cross:
        _norm_map(out, f"{ours}.cross_attn.norm",
                  f"{theirs}.cross_attn_block.cross_attn_norm", use_adaln)
        _attn_map(out, f"{ours}.cross_attn.attn",
                  f"{theirs}.cross_attn_block.cross_attn")
        _res_map(out, f"{ours}.cross_attn.res",
                 f"{theirs}.cross_attn_block.cross_attn_res", use_scale)
    _norm_map(out, f"{ours}.ffn.norm",
              f"{theirs}.feedforward_block.feedforward_norm", use_adaln)
    _mlp2_map(out, f"{ours}.ffn.ff", f"{theirs}.feedforward_block.feedforward")
    _res_map(out, f"{ours}.ffn.res",
             f"{theirs}.feedforward_block.feedforward_res", use_scale)


def fc_encoder_mapping(num_layers, ours="", theirs=""):
    out = []
    for i in range(num_layers):
        _conv_map(out, f"{ours}layers.{i}",
                  f"{theirs}fc_encoder_layer.{i}.conv_layer.0")
    return out


def fc_decoder_mapping(specs, ours="", theirs=""):
    """The reference's decoder: ``fc_decoder_layer.0`` is a stem of two
    convolutions, then one module per spec."""
    out = []
    for j, (_, _, kind) in enumerate(specs):
        if j == 0:
            tname = f"{theirs}fc_decoder_layer.0.0.conv_layer.0"
        elif j == 1:
            tname = f"{theirs}fc_decoder_layer.0.1.conv_layer.0"
        else:
            tname = f"{theirs}fc_decoder_layer.{j - 1}.conv_layer.0"
        _conv_map(out, f"{ours}layers.{j}", tname,
                  kind="convT" if kind == "up" else "conv")
    return out


def autoencoder_mapping(enc_specs, dec_specs):
    return (fc_encoder_mapping(len(enc_specs), "fc_encoder.", "fc_encoder.")
            + fc_decoder_mapping(dec_specs, "fc_decoder.", "fc_decoder."))


def codebook_mapping():
    return [("codebook", "codebook.weight", "plain")]


def transformer_mapping(cfg):
    """``cfg``: the model's ``TransformerConfig``.  The order of the
    reference ``Transformer.__init__``'s registrations."""
    out = []
    if cfg.use_encoder:
        out.append(("enc_embedding.w", "enc_embedding.weight", "plain"))
        for i in range(cfg.num_enc_layers):
            _block_map(out, f"encoder_layers.{i}", f"encoder_layers.{i}",
                       use_cross=False, use_adaln=False, use_scale=False)
    out.append(("dec_embedding.w", "dec_embedding.weight", "plain"))
    for i in range(cfg.num_dec_layers):
        _block_map(out, f"decoder_layers.{i}", f"decoder_layers.{i}",
                   use_cross=cfg.use_encoder, use_adaln=cfg.use_pos_cond,
                   use_scale=cfg.use_pos_cond)
    if cfg.use_pos_cond:
        _mlp2_map(out, "pos_cond_layer", "pos_cond_layer")
    _mlp2_map(out, "classifier", "classifier")
    return out


def mapping_for_model(model):
    """Mapping table of a port module (FCEncoder / FCDecoder / Autoencoder
    / Codebook / Transformer)."""
    from qaig_tpu_torch.models.codebook import Codebook
    from qaig_tpu_torch.models.conv_nets import (Autoencoder, FCDecoder,
                                                 FCEncoder)
    from qaig_tpu_torch.models.transformer import Transformer

    if isinstance(model, Autoencoder):
        return autoencoder_mapping(model.fc_encoder.specs,
                                   model.fc_decoder.specs)
    if isinstance(model, FCEncoder):
        return fc_encoder_mapping(len(model.specs))
    if isinstance(model, FCDecoder):
        return fc_decoder_mapping(model.specs)
    if isinstance(model, Codebook):
        return codebook_mapping()
    if isinstance(model, Transformer):
        return transformer_mapping(model.cfg)
    raise TypeError(f"Unsupported model type: {type(model)}")


# ---------------------------------------------------------------------------
# export entry points
# ---------------------------------------------------------------------------

def export_state_dict(module):
    """``module``'s parameters as a reference-named torch ``state_dict``
    ({name: float32 CPU tensor}).  Raises if a mapped path is missing: a
    silent partial export would break the reference's loader."""
    flat = convert.to_jax_state(module)
    sd = {}
    for ours, theirs, kind in mapping_for_model(module):
        if ours not in flat:
            raise KeyError(f"export: param path {ours!r} missing "
                           f"(wanted for torch key {theirs!r})")
        sd[theirs] = torch.from_numpy(to_torch_layout(flat[ours], kind))
    return sd


def export_checkpoint(model, ckpt, out_path, logging=print, optimizer=None,
                      learning_rate=None):
    """Write a reference-loadable ``.pt`` archive (``torch.save``): the
    checkpoint dict ``ckpt``'s schema (its hyperparameters and other
    entries as they are), with its state (``model``, or a codebook's
    ``checkpoint``) replaced by ``model``'s reference ``state_dict`` and
    ``model_optimizer`` by the torch Adam state of ``optimizer`` (a
    ``torch.optim.Adam`` over ``model``) when given.  Without
    ``optimizer``, a ``model_optimizer`` that already is a torch Adam state
    is kept (its arrays as tensors) and any other becomes None, as in
    ``qaig_tpu``'s exporter."""
    from qaig_tpu_torch.utils import torch_optim

    out = {key: value for key, value in ckpt.items()
           if key not in ("model", "checkpoint", "model_optimizer")}
    state_key = "checkpoint" if "checkpoint" in ckpt else "model"
    out[state_key] = export_state_dict(model)
    if optimizer is not None:
        out["model_optimizer"] = torch_optim.export_adam_state(
            model, optimizer, learning_rate=learning_rate)
    elif "model_optimizer" in ckpt:
        prev = ckpt["model_optimizer"]
        if torch_optim.is_torch_adam_state(prev):
            prev = dict(prev, state={
                k: {kk: torch.as_tensor(vv) for kk, vv in v.items()}
                for k, v in prev["state"].items()})
            out["model_optimizer"] = prev
        else:
            out["model_optimizer"] = None
    tmp = str(out_path) + ".tmp"
    torch.save(out, tmp)
    os.replace(tmp, str(out_path))
    logging(f"Exported reference-format checkpoint: {out_path}")
    return True
