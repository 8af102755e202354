"""Activation registry (counterpart of ``qaig_tpu/ops/activations.py``).

Only ``silu``, ``tanh`` and ``sigmoid`` exist; an unknown name raises
``KeyError``, as in the reference's ``ModuleDict`` lookup.
"""

import torch
import torch.nn.functional as F

_ACTIVATIONS = {
    "silu": F.silu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
}


def get_activation(activation_type):
    """Return the activation function for ``activation_type``."""
    return _ACTIVATIONS[activation_type]
