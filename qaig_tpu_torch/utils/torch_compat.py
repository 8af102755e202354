"""Reference (PyTorch) checkpoint import (counterpart of
``qaig_tpu/utils/torch_compat.py``).

Turns a reference torch ``state_dict`` (flat name -> array, e.g. the
reference's published weights) into ``qaig_tpu``'s flat JAX-layout state
and fills a port module from that through ``convert.load_jax_state``.
Going through the JAX layout keeps the port on ``qaig_tpu``'s layout
rules (see ``utils/torch_export.py``, whose mapping table this module
reads in the other direction).

Tolerant, as the reference's ``custom_load_state_dict`` is: names the
module lacks and shape mismatches are logged and skipped, which is what
lets an encoder or a decoder load from an autoencoder's state dict.  The
conv nets take the state dict with or without its ``fc_encoder.`` /
``fc_decoder.`` prefixes.
"""

from qaig_tpu_torch.convert import load_jax_state
from qaig_tpu_torch.utils import torch_export as te


def strip_prefix(sd, prefix):
    """Entries under ``prefix`` with it removed, the others as they are
    (the prefixed autoencoder form and the bare form both load)."""
    return {(name[len(prefix):] if name.startswith(prefix) else name): value
            for name, value in sd.items()}


def _flat(sd, mapping, ours_prefix=""):
    return {ours_prefix + ours: te.from_torch_layout(sd[theirs], kind)
            for ours, theirs, kind in mapping if theirs in sd}


def reference_to_jax_state(model, sd):
    """A reference state dict -> ``qaig_tpu``'s flat JAX-layout state for
    a port module (FCEncoder / FCDecoder / Autoencoder / Codebook /
    Transformer)."""
    from qaig_tpu_torch.models.conv_nets import (Autoencoder, FCDecoder,
                                                 FCEncoder)

    if isinstance(model, Autoencoder):
        enc, dec = model.fc_encoder, model.fc_decoder
        return {**_flat(strip_prefix(sd, "fc_encoder."),
                        te.fc_encoder_mapping(len(enc.specs)),
                        "fc_encoder."),
                **_flat(strip_prefix(sd, "fc_decoder."),
                        te.fc_decoder_mapping(dec.specs), "fc_decoder.")}
    if isinstance(model, FCEncoder):
        sd = strip_prefix(sd, "fc_encoder.")
    elif isinstance(model, FCDecoder):
        sd = strip_prefix(sd, "fc_decoder.")
    return _flat(sd, te.mapping_for_model(model))


def load_torch_into(model, torch_state_dict, logging=print):
    """Restore a reference state dict into ``model`` in place; returns
    ``model``."""
    return load_jax_state(model, reference_to_jax_state(
        model, torch_state_dict), logging=logging)
