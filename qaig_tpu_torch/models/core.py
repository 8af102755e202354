"""Parameter primitives: linear / MLP / norm / conv / embedding
(counterpart of ``qaig_tpu/models/core.py``).

Parameters live in ``torch.nn`` modules in PyTorch's layouts (Linear
``(out, in)``, Conv2d ``OIHW``, ConvTranspose2d ``(in, out, kH, kW)``);
``qaig_tpu_torch.convert`` maps ``qaig_tpu``'s trees onto them.  Modules
are created without initialization (``torch.nn.utils.skip_init``): a
checkpoint fills them, or :func:`init_parameters` does from an explicit
``torch.Generator`` with the reference's (PyTorch default) distributions.
The apply functions mirror the JAX ones and take the module holding the
parameters.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import skip_init

from qaig_tpu_torch.ops.linear_f32 import linear_f32

_LN_EPS = 1e-5  # torch nn.LayerNorm default


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def _skip_init(cls, *args, device=None, dtype=None, **kwargs):
    return skip_init(cls, *args, device=device or "cpu", dtype=dtype,
                     **kwargs)


def Linear(in_dim, out_dim, zero_weight=False, device=None, dtype=None):
    """``nn.Linear`` with uninitialized parameters.  ``zero_weight`` marks
    the AdaLN-Zero scale/shift and DiT gate layers, whose weight starts at
    zero (the bias keeps the default init)."""
    layer = _skip_init(nn.Linear, in_dim, out_dim, device=device, dtype=dtype)
    layer.zero_weight = zero_weight
    return layer


def LayerNorm(dim, device=None, dtype=None):
    return _skip_init(nn.LayerNorm, dim, eps=_LN_EPS, device=device,
                     dtype=dtype)


def Embedding(num_embeddings, dim, device=None, dtype=None):
    return _skip_init(nn.Embedding, num_embeddings, dim, device=device,
                     dtype=dtype)


def Conv2d(in_ch, out_ch, kernel_size=3, device=None, dtype=None):
    return _skip_init(nn.Conv2d, in_ch, out_ch, kernel_size, device=device,
                     dtype=dtype)


def ConvTranspose2d(in_ch, out_ch, kernel_size=4, device=None, dtype=None):
    return _skip_init(nn.ConvTranspose2d, in_ch, out_ch, kernel_size,
                     device=device, dtype=dtype)


class MLP2(nn.Module):
    """Two stacked linears ``l0``, ``l1`` (the activation placement is the
    caller's: act-on-first for Q/K/V and the classifier, act-on-both for
    the FFN)."""

    def __init__(self, in_dim, hidden_dim, out_dim, device=None, dtype=None):
        super().__init__()
        self.l0 = Linear(in_dim, hidden_dim, device=device, dtype=dtype)
        self.l1 = Linear(hidden_dim, out_dim, device=device, dtype=dtype)


@torch.no_grad()
def init_parameters(module, generator):
    """Fill every parameter of ``module`` from ``generator`` with the
    reference's distributions: Linear/Conv U(+-1/sqrt(fan_in)) for weight
    and bias (zero weight where marked), ConvTranspose2d with fan_in over
    its output channels, Embedding N(0, 1), LayerNorm ones/zeros, and any
    other parameter U(+-1/rows) (the codebook)."""
    for m in module.modules():
        params = list(m.parameters(recurse=False))
        if not params:
            continue
        if isinstance(m, nn.Linear):
            bound = 1.0 / math.sqrt(m.in_features)
            if getattr(m, "zero_weight", False):
                m.weight.zero_()
            else:
                m.weight.uniform_(-bound, bound, generator=generator)
            m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            kh, kw = m.kernel_size
            fan = (m.out_channels if isinstance(m, nn.ConvTranspose2d)
                   else m.in_channels) * kh * kw
            bound = 1.0 / math.sqrt(fan)
            m.weight.uniform_(-bound, bound, generator=generator)
            m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 1.0, generator=generator)
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        else:
            for p in params:
                bound = 1.0 / p.shape[0]
                p.uniform_(-bound, bound, generator=generator)
    return module


# ---------------------------------------------------------------------------
# apply functions
# ---------------------------------------------------------------------------

def linear(layer, x, activation=None):
    """``F.linear`` through :func:`~qaig_tpu_torch.ops.linear_f32.linear_f32`
    (float32 products on the card take the three-pass TF32 kernel)."""
    y = linear_f32(x, layer.weight, layer.bias)
    if activation is not None:
        y = activation(y)
    return y


def mlp2(params, x, act, act_last=False):
    """The two linears of an :class:`MLP2`.  Under tensor parallelism the
    module holds one shard and a ``tp`` link to the others: its rank's
    shard and the model group across processes
    (``parallel/sharding.py``, ``comm.ModelShards``), or shard 0 and the
    other cards' shards in one process (``parallel/local.py``,
    ``LocalShards``).  ``tp.sum_partials`` sums the shards' partial
    products of ``l1``, and ``l1``'s bias is added once, after the sum."""
    tp = getattr(params, "tp", None)
    if tp is None:
        h = linear(params.l0, x, activation=act)
        return linear(params.l1, h, activation=act if act_last else None)

    def partial(shard, xs):
        return linear_f32(linear(shard.l0, xs, activation=act),
                          shard.l1.weight)

    y = tp.sum_partials(partial, params, x) + params.l1.bias
    return act(y) if act_last else y


def layer_norm(x, eps=_LN_EPS):
    """Affine-free layer norm over the trailing axis; statistics in
    float32, result in the input dtype."""
    xf = x.to(torch.float32)
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def affine_layer_norm(params, x, eps=_LN_EPS):
    return layer_norm(x, eps) * params.weight + params.bias


def conv2d(params, x, stride=1, padding=1, activation=None):
    """Convolution on NCHW input with an OIHW kernel."""
    y = F.conv2d(x, params.weight, params.bias, stride=stride,
                 padding=padding)
    if activation is not None:
        y = activation(y)
    return y


def conv_transpose2d(params, x, stride=2, padding=1, activation=None):
    """Fractionally-strided convolution (the 2x upsample of
    ``ConvTranspose2d(k=4, s=2, p=1)``) on NCHW input."""
    y = F.conv_transpose2d(x, params.weight, params.bias, stride=stride,
                           padding=padding)
    if activation is not None:
        y = activation(y)
    return y


def embedding_lookup(params, indices):
    return F.embedding(indices, params.weight)
