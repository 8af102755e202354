"""Feature-map (cached encoder latent) dataset (counterpart of
``qaig_tpu/data/fmap_dataset.py``).

Each manifest row has ``fmap_path``, a raw ``.npy`` latent of shape
(C, H, W); items are loaded one by one with ``np.load`` as float32.  The
JAX package's native C++ batch loader and its image-pairing mode are not
part of the port.
"""

import numpy as np

from qaig_tpu_torch.data.manifest import Manifest


class FeatureMapDataset:
    def __init__(self, dataset_path):
        self.manifest = Manifest(dataset_path)
        if len(self.manifest) == 0:
            raise ValueError("No data found.")

    def __len__(self):
        return len(self.manifest)

    def __getitem__(self, index):
        with open(self.manifest[index]["fmap_path"], "rb") as f:
            return np.load(f).astype(np.float32)
