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

The optimizer state crosses the same way.  ``qaig_tpu``'s Adam is optax's
``(ScaleByAdamState(count, mu, nu), ScaleByScheduleState(count))`` (an
empty second state without a schedule), whose flat paths are ``0.0``
(count), ``0.1.<param path>`` (mu), ``0.2.<param path>`` (nu) and ``1.0``;
:func:`load_optax_state` maps them onto ``torch.optim.Adam``'s ``step``,
``exp_avg`` and ``exp_avg_sq`` with the weights' layout transforms, and
:func:`to_optax_state` writes the tree back with ``mu``/``nu`` as flat
dicts, which ``qaig_tpu``'s ``restore_opt_state`` restores by those paths.
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
def to_jax_state(module, params=None):
    """``module``'s parameters as a flat ``qaig_tpu`` state:
    ``{dotted.path: float32 ndarray}`` in JAX layouts.  ``params``
    ({torch name: tensor}) stands in for the module's own (the full
    tensors of a sharded model, or host copies of them)."""
    params = params if params is not None else dict(
        module.named_parameters())
    out = {}
    for jax_path, (torch_name, kind) in mapping(module).items():
        value = params[torch_name].detach().to("cpu", torch.float32).numpy()
        # a copy: a CPU float32 parameter's numpy view would alias it
        out[jax_path] = np.array(_to_jax_layout(value, kind), order="C")
    return out


@torch.no_grad()
def load_optax_state(module, optimizer, state, logging=print):
    """Fill ``optimizer`` (a ``torch.optim.Adam`` over ``module``'s
    parameters) from a ``qaig_tpu`` optax Adam state; returns its update
    count.  Parameters without moments in ``state`` keep a fresh state."""
    flat = flatten_tree(state)
    count = int(np.asarray(flat["0.0"]))
    params = dict(module.named_parameters())
    for jax_path, (torch_name, kind) in mapping(module).items():
        target = params[torch_name]
        moments = []
        for part in ("0.1", "0.2"):
            value = flat.get(f"{part}.{jax_path}")
            if value is not None:
                value = _to_torch_layout(value, kind)
            if value is None or tuple(value.shape) != tuple(target.shape):
                break
            moments.append(torch.from_numpy(np.array(
                value, dtype=np.float32)).to(target.device))
        if len(moments) != 2:
            logging(f"No optimizer state for {jax_path}, keeping a fresh "
                    "one")
            continue
        optimizer.state[target] = adam_entry(optimizer, target, count,
                                             *moments)
    return count


def adam_entry(optimizer, param, count, exp_avg, exp_avg_sq):
    """``torch.optim.Adam``'s state of ``param`` at update ``count``: the
    step on the parameter's device when its group is ``capturable`` (as
    Adam makes it), else on the CPU."""
    group = next(g for g in optimizer.param_groups
                 if any(p is param for p in g["params"]))
    device = param.device if group.get("capturable") else "cpu"
    return {"step": torch.tensor(float(count), dtype=torch.float32,
                                 device=device),
            "exp_avg": exp_avg, "exp_avg_sq": exp_avg_sq}


@torch.no_grad()
def to_optax_state(module, optimizer, scheduled=True, states=None):
    """``optimizer``'s Adam state as ``qaig_tpu``'s optax tree (moments in
    JAX layouts; zeros before the first update).  ``states`` ({torch name:
    Adam state}) stands in for the optimizer's (a sharded run's full
    moments, or host copies of them)."""
    mu, nu = {}, {}
    count = 0
    params = dict(module.named_parameters())
    for jax_path, (torch_name, kind) in mapping(module).items():
        target = params[torch_name]
        state = (states.get(torch_name, {}) if states is not None
                 else optimizer.state.get(target, {}))
        if "step" in state:
            count = int(state["step"])
        for out, key in ((mu, "exp_avg"), (nu, "exp_avg_sq")):
            value = state.get(key)
            value = (np.zeros(tuple(target.shape), np.float32)
                     if value is None
                     else value.detach().to("cpu", torch.float32).numpy())
            out[jax_path] = np.ascontiguousarray(_to_jax_layout(value, kind))
    count = np.asarray(count, np.int32)
    return ((count, mu, nu), (count,) if scheduled else ())
