"""Feature-map (cached encoder latent) dataset (counterpart of
``qaig_tpu/data/fmap_dataset.py``).

Each manifest row has ``fmap_path``, a raw ``.npy`` latent of shape
(C, H, W), and ``image_path``.  Items are loaded with ``np.load`` as
float32; :meth:`FeatureMapDataset.load_batch` loads a whole batch through
the data plane's native loader (``native.load_npy_batch``).  With
``load_image`` an item also carries its image, BGR in [-1, 1] and **HWC**:
the reference skips the CHW transpose on this path, and ``qaig_tpu``
keeps that, so the port does too.
"""

import numpy as np

from qaig_tpu_torch import native
from qaig_tpu_torch.data.image_dataset import read_image
from qaig_tpu_torch.data.manifest import Manifest


class FeatureMapDataset:
    def __init__(self, dataset_path, load_image=False, return_filepaths=False):
        self.load_image = load_image
        self.return_filepaths = return_filepaths
        self.manifest = Manifest(dataset_path)
        if len(self.manifest) == 0:
            raise ValueError("No data found.")
        self._item_shape = None

    def load_batch(self, indices, num_threads=4):
        """The batch's latents as one (N, C, H, W) float32 array through
        the native loader over ``num_threads`` threads, the item shape
        taken from the first item;
        ``None`` (item by item) with ``load_image`` or
        ``return_filepaths``, as in ``qaig_tpu``.  A file that cannot be
        read, or holds another size, raises an error naming it."""
        if self.load_image or self.return_filepaths:
            return None
        if self._item_shape is None:
            self._item_shape = self[indices[0]].shape
        paths = [self.manifest[i]["fmap_path"] for i in indices]
        return native.load_npy_batch(paths, self._item_shape, num_threads)

    def __len__(self):
        return len(self.manifest)

    def __getitem__(self, index):
        row = self.manifest[index]
        fmap_path = row["fmap_path"]
        with open(fmap_path, "rb") as f:
            fmap = np.load(f).astype(np.float32)

        if self.load_image:
            image_path = row["image_path"]
            image = np.ascontiguousarray(
                read_image(image_path).transpose(1, 2, 0))   # HWC
            if self.return_filepaths:
                return fmap, fmap_path, image, image_path
            return fmap, image

        if self.return_filepaths:
            return fmap, fmap_path
        return fmap
