"""Checkpoint persistence (counterpart of ``qaig_tpu/utils/checkpoint.py``).

The schema is ``qaig_tpu``'s: a plain dict {hyperparams..., "model": flat
``{dotted.path: ndarray}`` state, ...} pickled (protocol 4, numpy leaves)
and written atomically (tmp + rename) to ``<out>/models_checkpoint/<name>``.
``load_model`` returns ``(status, dict)``.  Either package reads what the
other writes.

Reading needs no JAX: classes from packages other than numpy and the
standard library (e.g. the optimizer state's named tuples) load as plain
tuples.  ``load_model`` also reads the reference's torch ``.pt`` zip
archives (``torch.load``, tensors to numpy), as ``qaig_tpu`` does, so a
caller sees the same dict from either package; unlike ``qaig_tpu`` it
loads them with ``weights_only=True``, which builds tensors, numpy
values and plain containers and runs no other pickled code;
``qaig_tpu_torch.train.common`` restores the reference state dicts and
Adam states they hold.  Not applicable: ``qaig_tpu``'s ``.orbax``
checkpoint directories (orbax imports JAX).
"""

import os
import pickle

_TRUSTED_MODULES = ("builtins", "collections", "copyreg", "_codecs",
                    "numpy", "ml_dtypes")


def _numpy_globals():
    """The numpy objects a torch archive may pickle beside its tensors
    (scalars and arrays among the hyperparameters), under numpy 1's and
    numpy 2's module names: all that ``torch.load(weights_only=True)`` is
    allowed to build besides tensors and plain containers."""
    import numpy as np
    try:
        from numpy._core import multiarray
    except ImportError:  # numpy 1
        from numpy.core import multiarray
    dtypes = {type(np.dtype(c)) for c in np.typecodes["All"]}
    names = [np.dtype, np.ndarray, *sorted(dtypes - {np.dtype}, key=str)]
    for fn in (multiarray.scalar, multiarray._reconstruct):
        for module in ("numpy.core.multiarray", "numpy._core.multiarray"):
            names.append((fn, f"{module}.{fn.__name__}"))
    return names


def _to_numpy(obj):
    import torch
    if isinstance(obj, dict):
        return {k: _to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        converted = [_to_numpy(v) for v in obj]
        return tuple(converted) if isinstance(obj, tuple) else converted
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    return obj


def save_model(model_dict, dest_path, file_name, logging=print):
    """Atomically pickle ``model_dict`` (tensors become numpy) to
    ``<dest>/models_checkpoint/<file_name>``; returns bool."""
    try:
        folder = os.path.join(str(dest_path), "models_checkpoint")
        os.makedirs(folder, exist_ok=True)
        path = os.path.join(folder, file_name)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(_to_numpy(model_dict), f, protocol=4)
        os.replace(tmp, path)
        return True
    except Exception as e:  # the reference's boolean contract
        logging(f"Exception occured while saving model: {e}.")
        return False


class _Unpickler(pickle.Unpickler):
    """Loads numpy and standard-library objects as themselves and any
    other class as a tuple subclass of the same name, so a checkpoint
    written with JAX-side objects (optax states) loads without importing
    their packages."""

    def find_class(self, module, name):
        if module.split(".")[0] in _TRUSTED_MODULES:
            return super().find_class(module, name)
        return type(name, (tuple,), {
            "__new__": lambda cls, *args: tuple.__new__(cls, args),
            "__setstate__": lambda self, state: None,
            "__module__": module})


def load_model(checkpoint_path, logging=print):
    """Load a pickle checkpoint or a reference torch ``.pt`` archive
    (tensors become numpy); returns (status, dict)."""
    checkpoint_path = str(checkpoint_path)
    if not os.path.isfile(checkpoint_path):
        logging("Checkpoint does not exist.")
        return False, None
    try:
        with open(checkpoint_path, "rb") as f:
            if f.read(2) == b"PK":   # torch zip archive
                import torch
                with torch.serialization.safe_globals(_numpy_globals()):
                    return True, _to_numpy(torch.load(
                        checkpoint_path, map_location="cpu",
                        weights_only=True))
            f.seek(0)
            return True, _Unpickler(f).load()
    except Exception as e:
        logging(f"Failed to load checkpoint {checkpoint_path}: {e}")
        return False, None


def flatten_tree(tree, prefix=""):
    """Nested dict/list tree -> {dotted.path: leaf}."""
    flat = {}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    for key, value in items:
        path = f"{prefix}.{key}" if prefix else str(key)
        flat.update(flatten_tree(value, path))
    return flat


def unflatten_tree(flat, like):
    """Rebuild a tree with the structure of ``like`` from dotted paths."""
    def build(node, prefix):
        if isinstance(node, dict):
            return {k: build(v, f"{prefix}.{k}" if prefix else str(k))
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            rebuilt = [build(v, f"{prefix}.{i}" if prefix else str(i))
                       for i, v in enumerate(node)]
            return rebuilt if isinstance(node, list) else tuple(rebuilt)
        return flat[prefix]
    return build(like, "")
