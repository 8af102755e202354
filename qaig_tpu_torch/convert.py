"""Parameter conversion between ``qaig_tpu``'s trees and the port's modules.

``qaig_tpu`` keeps parameters as nested dicts of numpy/JAX arrays in JAX
layouts; its checkpoints store them flat, as ``{dotted.path: ndarray}``.
The port's modules carry the same names (``decoder_layers.0.self_attn.
attn.q.l0``), so the mapping is per leaf:

* dense ``w`` ``(in, out)`` -> ``Linear.weight`` ``(out, in)``, ``b`` ->
  ``bias``;
* conv ``w`` HWIO -> ``Conv2d.weight`` OIHW;
* transposed conv ``w``, stored spatially flipped HWIO (correlation-ready)
  -> ``ConvTranspose2d.weight`` ``(in, out, kH, kW)`` unflipped;
* LayerNorm ``g``/``b`` -> ``weight``/``bias``; Embedding ``w`` ->
  ``weight``;
* any other parameter (the codebook) keeps its name and layout.

:func:`load_jax_state` fills a module from such a state (tolerantly: unknown
paths and shape mismatches are logged and skipped, as ``qaig_tpu``'s
``tolerant_restore`` does); :func:`to_jax_state` is its inverse, for writing
``qaig_tpu``-schema checkpoints.
"""

import numpy as np
import torch
from torch import nn

from qaig_tpu_torch.utils.checkpoint import flatten_tree


def _to_torch_layout(value, kind):
    v = np.asarray(value)
    if kind == "linear":
        return v.T
    if kind == "conv":
        return v.transpose(3, 2, 0, 1)
    if kind == "convT":
        return v.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
    return v


def _to_jax_layout(value, kind):
    if kind == "linear":
        return value.T
    if kind == "conv":
        return value.transpose(2, 3, 1, 0)
    if kind == "convT":
        return value[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)
    return value


def mapping(module):
    """{jax dotted path: (torch parameter name, layout kind)} for every
    parameter of ``module``."""
    table = {}
    for prefix, m in module.named_modules():
        def add(jax_leaf, torch_leaf, kind):
            jax_path = f"{prefix}.{jax_leaf}" if prefix else jax_leaf
            torch_name = f"{prefix}.{torch_leaf}" if prefix else torch_leaf
            table[jax_path] = (torch_name, kind)

        if isinstance(m, nn.Linear):
            add("w", "weight", "linear")
            add("b", "bias", "plain")
        elif isinstance(m, nn.ConvTranspose2d):
            add("w", "weight", "convT")
            add("b", "bias", "plain")
        elif isinstance(m, nn.Conv2d):
            add("w", "weight", "conv")
            add("b", "bias", "plain")
        elif isinstance(m, nn.LayerNorm):
            add("g", "weight", "plain")
            add("b", "bias", "plain")
        elif isinstance(m, nn.Embedding):
            add("w", "weight", "plain")
        else:
            for name, _ in m.named_parameters(recurse=False):
                add(name, name, "plain")
    return table


@torch.no_grad()
def load_jax_state(module, state, key_map=None, logging=print):
    """Copy a ``qaig_tpu`` parameter state (flat ``{dotted.path: array}``
    or the nested tree) into ``module`` in place, converting layouts.
    ``key_map`` rewrites each source path first (None drops it).  Paths
    with no parameter and shape mismatches are logged and skipped.
    Returns ``module``."""
    if any(isinstance(v, (dict, list, tuple)) for v in state.values()):
        state = flatten_tree(state)
    table = mapping(module)
    params = dict(module.named_parameters())
    for name, value in state.items():
        if key_map is not None:
            name = key_map(name)
            if name is None:
                continue
        if name not in table:
            logging(f"No Layer found: {name}, skipping")
            continue
        torch_name, kind = table[name]
        target = params[torch_name]
        array = _to_torch_layout(value, kind)
        if tuple(array.shape) != tuple(target.shape):
            logging(f"Skipped: {name}")
            continue
        if array.dtype.kind not in "biuf":   # e.g. ml_dtypes bfloat16
            array = array.astype(np.float32)
        target.copy_(torch.from_numpy(np.array(array, copy=True)))
    return module


@torch.no_grad()
def to_jax_state(module):
    """``module``'s parameters as a flat ``qaig_tpu`` state:
    ``{dotted.path: float32 ndarray}`` in JAX layouts."""
    params = dict(module.named_parameters())
    out = {}
    for jax_path, (torch_name, kind) in mapping(module).items():
        value = params[torch_name].detach().to("cpu", torch.float32).numpy()
        out[jax_path] = np.ascontiguousarray(_to_jax_layout(value, kind))
    return out
