"""Sinusoidal positional embeddings (counterpart of
``qaig_tpu/ops/posemb.py``).

Frequencies are ``exp(arange(half) * -log(10000)/(half-1))`` and the output
is ``concat(sin, cos)`` along a new trailing feature axis.  Positions may be
any (non-contiguous, float) indices.
"""

import math

import torch


def sinusoidal_pos_emb(emb_dim, pos_index):
    """Float32 embedding of shape ``pos_index.shape + (emb_dim,)`` on
    ``pos_index``'s device."""
    half_dim = emb_dim // 2
    exponent = math.log(10_000.0) / (half_dim - 1)
    freqs = torch.exp(
        torch.arange(half_dim, dtype=torch.float32, device=pos_index.device)
        * -exponent)
    angles = pos_index.to(torch.float32)[..., None] * freqs
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)
