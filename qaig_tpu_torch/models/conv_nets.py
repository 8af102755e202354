"""Fully-convolutional encoder, decoder and autoencoder (counterpart of
``qaig_tpu/models/conv_nets.py``).

Exact channel progressions and activation placement of the reference
``FC_Encoder`` (stem -> [conv + 2x strided-conv downsample] * num_layers ->
latent head), ``FC_Decoder`` (2-conv stem -> [conv + 2x transposed-conv
upsample] * num_layers -> image head) and ``Autoencoder``.  NCHW
throughout, OIHW kernels.  Parameter names follow ``qaig_tpu``'s trees
(``fc_encoder.layers.<i>``), so ``qaig_tpu_torch.convert`` maps them as
they are.
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


def _encoder_channels(cfg: ConvNetConfig):
    """(in, out, kind) triples, kind in {conv, down, head}."""
    specs = [(cfg.image_channel, cfg.min_channel, "conv")]
    curr = cfg.min_channel
    for _ in range(cfg.num_layers):
        specs.append((curr, curr, "conv"))
        nxt = curr * 2 if curr * 2 < cfg.max_channel else cfg.max_channel
        specs.append((curr, nxt, "down"))
        curr = nxt
    specs.append((curr, cfg.latent_channel, "head"))
    return specs


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


class _ConvStack(nn.Module):
    """Sequential conv stack driven by (in, out, kind) specs."""

    def __init__(self, cfg: ConvNetConfig, specs, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.specs = specs
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
                x = core.conv2d(layer, x, stride=2 if kind == "down" else 1,
                                padding=1,
                                activation=final_act if kind == "head"
                                else hidden_act)
        return x


class FCEncoder(_ConvStack):
    """image (N, 3, H, W) -> latent (N, C, H / 2^num_layers, ...)."""

    def __init__(self, cfg: ConvNetConfig, device=None, dtype=None):
        super().__init__(cfg, _encoder_channels(cfg), device, dtype)


class FCDecoder(_ConvStack):
    """latent (N, C, h, w) -> image (N, 3, h * 2^num_layers, ...)."""

    def __init__(self, cfg: ConvNetConfig, device=None, dtype=None):
        super().__init__(cfg, _decoder_channels(cfg), device, dtype)


@dataclass(frozen=True)
class AutoencoderConfig:
    num_layers: int = 2
    image_channel: int = 3
    min_channel: int = 128
    max_channel: int = 512
    latent_channel: int = 2
    hidden_activation_type: str = "silu"
    use_final_enc_activation: bool = True
    encoder_activation_type: str = "silu"
    use_final_dec_activation: bool = True
    decoder_activation_type: str = "tanh"

    def _stack_config(self, use_final_activation, final_activation_type):
        return ConvNetConfig(
            num_layers=self.num_layers, image_channel=self.image_channel,
            min_channel=self.min_channel, max_channel=self.max_channel,
            latent_channel=self.latent_channel,
            hidden_activation_type=self.hidden_activation_type,
            use_final_activation=use_final_activation,
            final_activation_type=final_activation_type)

    def encoder_config(self):
        return self._stack_config(self.use_final_enc_activation,
                                  self.encoder_activation_type)

    def decoder_config(self):
        return self._stack_config(self.use_final_dec_activation,
                                  self.decoder_activation_type)


class Autoencoder(nn.Module):
    """Encoder + decoder (reference ``models/Autoencoder.py``)."""

    def __init__(self, cfg: AutoencoderConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.fc_encoder = FCEncoder(cfg.encoder_config(), device, dtype)
        self.fc_decoder = FCDecoder(cfg.decoder_config(), device, dtype)

    def get_latent(self, x):
        return self.fc_encoder(x)

    def recon_image(self, z):
        return self.fc_decoder(z)

    def forward(self, x):
        """NCHW image -> NCHW reconstruction."""
        return self.fc_decoder(self.fc_encoder(x))
