"""SOM-style codebook, generation half (counterpart of
``qaig_tpu/models/codebook.py``).

Only what image generation needs: the token -> patch lookup and unpatchify
(``get_quantized_image``) and the token count ``seq_len``.  The BMU search
and codebook training belong to the training slice.
"""

import torch
from torch import nn

from qaig_tpu_torch.ops.patch import unpatchify


class Codebook(nn.Module):
    def __init__(self, patch_dim=(2, 2), image_dim=(32, 32), image_channel=4,
                 num_embeddings=512, init_neighbour_range=256, device=None,
                 dtype=None):
        super().__init__()
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
