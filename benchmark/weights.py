"""Weights and data drawn from a run's seed, on the run's device.

One ``torch.Generator`` on the device draws every parameter of a set of
modules in one uniform call, scaled per parameter by the rule its module
kind gives (:func:`fill_rule`) in two more calls, and copied into the
modules with one ``_foreach_copy_``.  The benchmark keeps its own flat copy
(:class:`Weights`), in the served dtype, from which the plain reference
takes its parameters by name: the reference never reads the program's
modules.
"""

import math

import torch
from torch import nn

# one generator stream per purpose, so that adding a draw to one never
# moves another
STREAM_WEIGHTS = 1
STREAM_DATA = 2


def generator(seed, stream, device):
    """A generator on ``device`` for one purpose of a run's seed."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 16 + stream) % (2 ** 63))


def fill_rule(module, name):
    """(scale, shift) of parameter ``name`` of ``module`` over U(-1, 1).

    Linear weight and bias U(+-1/sqrt(fan_in)), AdaLN-Zero and gate layers
    included; convolutions as PyTorch's default (fan over the input, over
    the output for a transposed one); embeddings U(+-sqrt(3)) (variance
    1); layer norms weight 1+U(+-0.1), bias U(+-0.1); anything else (the
    codebooks' codes) U(+-1)."""
    if isinstance(module, nn.Linear):
        return 1.0 / math.sqrt(module.in_features), 0.0
    if isinstance(module, (nn.Conv2d, nn.ConvTranspose2d)):
        kh, kw = module.kernel_size
        fan = (module.out_channels if isinstance(module, nn.ConvTranspose2d)
               else module.in_channels) * kh * kw
        return 1.0 / math.sqrt(fan), 0.0
    if isinstance(module, nn.Embedding):
        return math.sqrt(3.0), 0.0
    if isinstance(module, nn.LayerNorm):
        return 0.1, (1.0 if name == "weight" else 0.0)
    return 1.0, 0.0


class Weights:
    """The benchmark's copy of a set of parameters: one flat tensor and,
    by name, views of it."""

    def __init__(self, flat, names, shapes):
        self.flat = flat
        self.names = names
        self.shapes = shapes

    def views(self, prefix="", dtype=torch.float32):
        """``{name without prefix: tensor}`` of the names under
        ``prefix``, cast to ``dtype`` (copies when it differs)."""
        out, offset = {}, 0
        for name, shape in zip(self.names, self.shapes):
            n = math.prod(shape)
            if name.startswith(prefix):
                out[name[len(prefix):]] = self.flat[offset:offset + n].view(
                    shape).to(dtype)
            offset += n
        return out


def draw(modules, seed, device, dtype, overrides=None, scales=None):
    """Fill every parameter of ``modules`` ({prefix: module}) from the seed
    and return the benchmark's :class:`Weights`.  ``overrides`` ({full
    name: tensor}) replaces a parameter's draw with a given value (the
    training cell's codebooks, which are the data's own); ``scales``
    ({module name suffix: factor}) multiplies the draw of the parameters
    of the modules whose names end so."""
    overrides = overrides or {}
    widen = scales or {}
    params, names, scales, shifts = [], [], [], []
    for prefix, root in modules.items():
        for mname, module in root.named_modules():
            for pname, p in module.named_parameters(recurse=False):
                full = f"{prefix}{mname + '.' if mname else ''}{pname}"
                scale, shift = fill_rule(module, pname)
                for suffix, factor in widen.items():
                    if mname.endswith(suffix):
                        scale *= factor
                params.append(p)
                names.append(full)
                scales.append(scale)
                shifts.append(shift)
    numels = [p.numel() for p in params]
    counts = torch.tensor(numels, device=device)
    gen = generator(seed, STREAM_WEIGHTS, device)
    flat = torch.empty(sum(numels), device=device).uniform_(-1.0, 1.0,
                                                            generator=gen)
    flat.mul_(torch.tensor(scales, device=device).repeat_interleave(counts))
    flat.add_(torch.tensor(shifts, device=device).repeat_interleave(counts))
    flat = flat.to(dtype)
    offset = 0
    for name, n in zip(names, numels):
        if name in overrides:
            flat[offset:offset + n] = overrides[name].reshape(-1).to(dtype)
        offset += n
    views = [v.view(p.shape) for v, p in zip(flat.split(numels), params)]
    with torch.no_grad():
        torch._foreach_copy_(params, views)
    return Weights(flat, names, [tuple(p.shape) for p in params])
