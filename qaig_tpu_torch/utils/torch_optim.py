"""Reference torch Adam state <-> the port's ``torch.optim.Adam``
(counterpart of ``qaig_tpu/utils/torch_optim.py``).

The reference resumes Adam from ``model_optimizer``, an
``Adam.state_dict()``: ``{"state": {index: {"step", "exp_avg",
"exp_avg_sq"}}, "param_groups": [...]}``.  Its indices follow the
reference's ``model.parameters()`` order, which is the order of the
mapping table in ``utils/torch_export.py``, not the port's own parameter
order; the moments take the same per-parameter layout transforms as the
weights (reference layout -> JAX layout -> the port's).

Import (:func:`import_adam_state`) fills the port's Adam as ``qaig_tpu``
fills its optax state: one update count for every parameter (the largest
reference ``step``), zero moments where the reference has none.  It
writes the optimizer's per-parameter state only; its group settings
(``capturable``, the learning-rate tensor on the card) stay the port's, so
the reference's ``"capturable": False`` and ``lr`` are not read.  The
caller puts the halving schedule at the returned count
(``train/optim.py::set_update_count``), where ``qaig_tpu`` restarts its
schedule's count at 0: the two agree until the first halving.

Export (:func:`export_adam_state`): the port's Adam -> a torch-loadable
state dict, one parameter group, so training started here resumes under
the reference.
"""

import numpy as np
import torch

from qaig_tpu_torch import convert
from qaig_tpu_torch.utils import torch_export as te


def is_torch_adam_state(obj):
    return isinstance(obj, dict) and "param_groups" in obj and "state" in obj


def _params_in_table_order(model):
    """[(reference index, reference name, kind, port parameter, port
    kind)] over the mapping table."""
    table = convert.mapping(model)
    params = dict(model.named_parameters())
    out = []
    for idx, (ours, theirs, kind) in enumerate(te.mapping_for_model(model)):
        name, port_kind = table[ours]
        out.append((idx, theirs, kind, params[name], port_kind))
    return out


@torch.no_grad()
def import_adam_state(model, optimizer, torch_opt, logging=print):
    """Fill ``optimizer`` (a ``torch.optim.Adam`` over ``model``) from a
    reference Adam state dict; returns the update count."""
    state = {int(k): v for k, v in torch_opt.get("state", {}).items()}
    moments, steps = {}, set()
    for idx, theirs, kind, param, port_kind in _params_in_table_order(model):
        entry = state.get(idx)
        if entry is None:
            logging(f"No optimizer state for param {idx} ({theirs}), "
                    "keeping zeros")
            continue
        pair = [convert._to_torch_layout(
            te.from_torch_layout(entry[key], kind), port_kind)
            for key in ("exp_avg", "exp_avg_sq")]
        if any(tuple(m.shape) != tuple(param.shape) for m in pair):
            logging(f"Optimizer shape mismatch at {theirs}, skipping")
            continue
        moments[param] = [torch.from_numpy(np.array(m, dtype=np.float32))
                          .to(param.device) for m in pair]
        steps.add(int(np.asarray(entry["step"]).item()))
    if len(steps) > 1:
        logging(f"Torch Adam steps differ across params ({sorted(steps)}); "
                "using max")
    count = max(steps) if steps else 0
    for _, _, _, param, _ in _params_in_table_order(model):
        pair = moments.get(param) or [torch.zeros_like(param)
                                      for _ in range(2)]
        optimizer.state[param] = convert.adam_entry(optimizer, param, count,
                                                    *pair)
    return count


@torch.no_grad()
def export_adam_state(model, optimizer, learning_rate=None,
                      betas=(0.5, 0.999), eps=1e-8):
    """``optimizer``'s Adam state -> a reference ``Adam.state_dict()``
    (one parameter group, indexed in the mapping table's order); zero
    moments at step 0 for a parameter not updated yet."""
    entries = _params_in_table_order(model)
    steps = [int(optimizer.state[p]["step"]) for _, _, _, p, _ in entries
             if "step" in optimizer.state.get(p, {})]
    step = max(steps) if steps else 0
    state = {}
    for idx, _, kind, param, port_kind in entries:
        slot = optimizer.state.get(param, {})
        pair = []
        for key in ("exp_avg", "exp_avg_sq"):
            value = slot.get(key)
            # a copy: a CPU moment's numpy view would alias the live state
            value = (np.zeros(tuple(param.shape), np.float32) if value is None
                     else value.detach().to("cpu", torch.float32).numpy()
                     .copy())
            pair.append(torch.from_numpy(te.to_torch_layout(
                convert._to_jax_layout(value, port_kind), kind)))
        state[idx] = {"step": torch.tensor(float(step)),
                      "exp_avg": pair[0], "exp_avg_sq": pair[1]}
    group = {
        "lr": float(learning_rate) if learning_rate is not None else 1e-4,
        "betas": tuple(betas),
        "eps": float(eps),
        "weight_decay": 0,
        "amsgrad": False,
        "maximize": False,
        "foreach": None,
        "capturable": False,
        "differentiable": False,
        "fused": None,
        "params": list(range(len(entries))),
    }
    return {"state": state, "param_groups": [group]}
