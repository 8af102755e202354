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

Background writes (``backend="pickle-async"``, the role of ``qaig_tpu``'s
``orbax-async``): the trainers take :func:`host_snapshot` copies of the
tensors a checkpoint holds (pinned host memory, complete before the next
graphed step updates the parameters in place) and hand ``save_model`` a
function that builds the checkpoint from them; one background thread runs
it and writes the same pickle, atomically.  At most one write is in
flight: the next save joins it, and so does :func:`wait_pending_saves`,
which the trainers call at the end of their run and on error.
"""

import os
import pickle
import threading

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


def host_snapshot(tree):
    """``tree`` (dicts, lists and tuples) with each tensor copied to host
    memory: into pinned memory, queued on the current stream and waited
    for, when it lies on the card.  A background write reads these copies
    while the training steps update the tensors in place."""
    import torch
    on_card = []

    def copy(obj):
        if isinstance(obj, torch.Tensor):
            obj = obj.detach()
            if not obj.is_cuda:
                return obj.clone()
            on_card.append(obj)
            return torch.empty(obj.shape, dtype=obj.dtype,
                               pin_memory=True).copy_(obj, non_blocking=True)
        if isinstance(obj, dict):
            return {k: copy(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return type(obj)(copy(v) for v in obj)
        return obj
    out = copy(tree)
    if on_card:
        torch.cuda.synchronize()
    return out


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


BACKENDS = ("pickle", "pickle-async")

# the background write in flight: (thread, its error list, its path)
_pending = []


def pending_paths():
    """Paths whose background write has not finished."""
    return {path for thread, _, path in _pending if thread.is_alive()}


def wait_pending_saves(logging=print):
    """Join the background write in flight, if any; False when it
    failed."""
    ok = True
    while _pending:
        thread, errors, path = _pending.pop()
        thread.join()
        for e in errors:
            logging(f"Async checkpoint save of {path} failed: {e}.")
            ok = False
    return ok


def _write(model_dict, path):
    if callable(model_dict):
        model_dict = model_dict()
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(_to_numpy(model_dict), f, protocol=4)
    os.replace(tmp, path)


def save_model(model_dict, dest_path, file_name, logging=print,
               backend="pickle"):
    """Atomically pickle ``model_dict`` (tensors become numpy) to
    ``<dest>/models_checkpoint/<file_name>``; returns bool.  ``model_dict``
    may be a function that builds the dict.  ``backend="pickle-async"``
    returns at once and builds and writes the file on a background thread
    (the next save, or :func:`wait_pending_saves`, joins it; its failure
    shows there), so the function must read host copies only
    (:func:`host_snapshot`)."""
    if backend not in BACKENDS:
        raise ValueError(f"checkpoint backend {backend!r}: the port writes "
                         f"{' or '.join(BACKENDS)}")
    try:
        folder = os.path.join(str(dest_path), "models_checkpoint")
        os.makedirs(folder, exist_ok=True)
        path = os.path.join(folder, file_name)
        if not wait_pending_saves(logging=logging):  # one write at a time
            return False
        if backend == "pickle-async":
            errors = []

            def write():
                try:
                    _write(model_dict, path)
                except Exception as e:
                    errors.append(e)
            thread = threading.Thread(target=write, name="checkpoint-write")
            _pending.append((thread, errors, path))
            thread.start()
            return True
        _write(model_dict, path)
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
