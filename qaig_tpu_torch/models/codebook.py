"""SOM-style codebook: patchified-latent quantization (counterpart of
``qaig_tpu/models/codebook.py``).

* best-matching-unit (BMU) search = L2 argmin of each patch against all
  codes (``qaig_tpu_torch.ops.bmu``: the hand-written kernel on the card);
* soft ("Gaussian") quantization spreads each patch over the codes whose
  *embedding index* is near the BMU index -- a 1-D Gaussian in index space
  with variance ``-(range / (2 ln 0.1))`` -- giving the SOM neighbourhood
  pull; hard quantization is a plain code lookup;
* ``decrease_neighbourhood`` shrinks the range by 1 per call, floored at 1.

Gradients flow as in the JAX package: the BMU indices carry none, the
soft-quantize product carries d/d(codebook).  ``forward`` is the
counterpart of ``Codebook.apply`` (quantize + unpatchify).
"""

import math

import torch
from torch import nn

from qaig_tpu_torch.ops.bmu import bmu_argmin
from qaig_tpu_torch.ops.patch import patchify, unpatchify


class Codebook(nn.Module):
    def __init__(self, patch_dim=(2, 2), image_dim=(32, 32), image_channel=4,
                 num_embeddings=512, init_neighbour_range=256, device=None,
                 dtype=None):
        super().__init__()
        # the JAX package's check, kept as it is (it can never fire)
        if init_neighbour_range > num_embeddings and init_neighbour_range < 1:
            raise ValueError("Invalid value for init_neighbour_range.")
        self.neighbourhood_range = init_neighbour_range
        self.patch_dim = tuple(patch_dim)
        self.image_dim = tuple(image_dim)
        self.image_channel = image_channel
        patch_h, patch_w = self.patch_dim
        self.embedding_dim = image_channel * patch_h * patch_w
        self.num_embeddings = num_embeddings
        self.codebook = nn.Parameter(torch.empty(
            num_embeddings, self.embedding_dim, device=device, dtype=dtype))

    @property
    def seq_len(self):
        h, w = self.image_dim
        ph, pw = self.patch_dim
        return (h // ph) * (w // pw)

    @torch.no_grad()
    def init(self, generator):
        """U(-1/K, 1/K) codes drawn from ``generator``; returns self."""
        bound = 1.0 / self.num_embeddings
        self.codebook.uniform_(-bound, bound, generator=generator)
        return self

    def decrease_neighbourhood(self, steps=1):
        if steps < 1:
            raise ValueError("Invalid value for steps, should be >= 1.")
        self.neighbourhood_range = (
            1.0 if self.neighbourhood_range <= 1
            else self.neighbourhood_range - 1)

    def get_patches_bmu(self, x, reshape=False):
        """(N, C, H, W) float32 -> flat (N*Seq,) BMU indices (or (N, Seq)
        when ``reshape``)."""
        x_patches = patchify(x, patch_dim=self.patch_dim)
        n, seq, d = x_patches.shape
        bmu = bmu_argmin(x_patches.reshape(n * seq, d).contiguous(),
                         self.codebook)
        return bmu.reshape(n, seq) if reshape else bmu

    def get_quantized_patches(self, x, use_gaussian=True,
                              neighbourhood_range=None):
        """(N, C, H, W) -> (N, Seq, D) quantized patches: the Gaussian
        neighbourhood blend of the codes (``use_gaussian``) or the BMU
        codes themselves."""
        bmu = self.get_patches_bmu(x)
        if use_gaussian:
            if neighbourhood_range is None:
                neighbourhood_range = self.neighbourhood_range
            scale = gaussian_neighbourhood(bmu, self.num_embeddings,
                                           neighbourhood_range)
            quantized = scale @ self.codebook        # (N*Seq, K) @ (K, D)
        else:
            quantized = self.codebook[bmu]
        return quantized.reshape(x.shape[0], -1, self.embedding_dim)

    def get_quantized_image(self, indices, unpatchify_input=True):
        """(N, Seq) token ids -> (N, C, H, W) latent (or (N, Seq, D)
        patches without ``unpatchify_input``)."""
        n, seq = indices.shape
        quantized = self.codebook[indices.reshape(-1)].reshape(
            n, seq, self.embedding_dim)
        if unpatchify_input:
            return unpatchify(quantized, image_dim=self.image_dim,
                              patch_dim=self.patch_dim)
        return quantized

    def forward(self, x, use_gaussian=True, neighbourhood_range=None):
        """Quantize + unpatchify: (N, C, H, W) -> (N, C, H, W)."""
        quantized = self.get_quantized_patches(
            x, use_gaussian=use_gaussian,
            neighbourhood_range=neighbourhood_range)
        return unpatchify(quantized, image_dim=self.image_dim,
                          patch_dim=self.patch_dim)


def gaussian_neighbourhood(bmu, num_embeddings, neighbourhood_range):
    """(M, K) SOM neighbourhood weights: a 1-D Gaussian over the
    embedding-index distance from each BMU."""
    variance = -(neighbourhood_range / (2.0 * math.log(0.1)))
    idx = torch.arange(num_embeddings, dtype=torch.float32,
                       device=bmu.device)[None, :]
    delta = idx - bmu.to(torch.float32)[:, None]
    return torch.exp(-(delta * delta) / (2.0 * variance))
