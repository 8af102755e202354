"""Fully-convolutional decoder (counterpart of the generation half of
``qaig_tpu/models/conv_nets.py``).

Exact channel progression and activation placement of the reference
``FC_Decoder``: 2-conv stem -> [conv + 2x transposed-conv upsample] *
num_layers -> image head.  NCHW throughout, OIHW kernels.  The encoder and
autoencoder belong to the training slice.
"""

from dataclasses import dataclass

from torch import nn

from qaig_tpu_torch.models import core
from qaig_tpu_torch.ops.activations import get_activation


@dataclass(frozen=True)
class ConvNetConfig:
    num_layers: int = 2
    image_channel: int = 3
    min_channel: int = 128
    max_channel: int = 512
    latent_channel: int = 2
    hidden_activation_type: str = "silu"
    use_final_activation: bool = True
    final_activation_type: str = "tanh"


def _decoder_channels(cfg: ConvNetConfig):
    """(in, out, kind) triples, kind in {conv, up, head}."""
    specs = [
        (cfg.latent_channel, cfg.max_channel, "conv"),
        (cfg.max_channel, cfg.max_channel, "conv"),
    ]
    curr = cfg.max_channel
    for _ in range(cfg.num_layers):
        specs.append((curr, curr, "conv"))
        nxt = curr // 2 if curr // 2 > cfg.min_channel else cfg.min_channel
        specs.append((curr, nxt, "up"))
        curr = nxt
    specs.append((curr, cfg.image_channel, "head"))
    return specs


class FCDecoder(nn.Module):
    """latent (N, C, h, w) -> image (N, 3, h * 2^num_layers, ...)."""

    def __init__(self, cfg: ConvNetConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.specs = _decoder_channels(cfg)
        self.layers = nn.ModuleList(
            core.ConvTranspose2d(i, o, 4, device=device, dtype=dtype)
            if kind == "up" else core.Conv2d(i, o, 3, device=device,
                                             dtype=dtype)
            for i, o, kind in self.specs)

    def forward(self, x):
        cfg = self.cfg
        hidden_act = get_activation(cfg.hidden_activation_type)
        final_act = (get_activation(cfg.final_activation_type)
                     if cfg.use_final_activation else None)
        for layer, (_, _, kind) in zip(self.layers, self.specs):
            if kind == "up":
                x = core.conv_transpose2d(layer, x, stride=2, padding=1,
                                          activation=hidden_act)
            else:
                x = core.conv2d(layer, x, stride=1, padding=1,
                                activation=final_act if kind == "head"
                                else hidden_act)
        return x
