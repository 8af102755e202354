"""Image dataset over a TinyDB-format manifest (counterpart of
``qaig_tpu/data/image_dataset.py``).

The pixel semantics are ``qaig_tpu``'s (``cv2.imread``): BGR channel
order, scaled to [-1, 1] by ``(x - 127.5) / 127.5``, CHW float32.  The port
does not need OpenCV:

* PNG goes through the data plane's native decoder (``native/``, C++
  built with ``g++`` at first use), which reads what ``cv2.imread`` reads
  (gray repeated over three channels, alpha dropped, 16-bit samples cut to
  their high byte); ``utils/png.py::read_bgr`` is its plain version.  PNG
  is lossless, so the arrays equal ``qaig_tpu``'s exactly.  An item is a
  batch of one; :meth:`ImageDataset.load_batch` decodes a whole batch.
* JPEG goes through PIL, one item at a time.  PIL's libjpeg and OpenCV's
  may round the IDCT differently, so a decoded JPEG can differ from
  ``qaig_tpu``'s by a unit here and there (``qaig_tpu`` says the same of
  its own native loader).  Without PIL a JPEG raises an error naming the
  missing decoder; it is never skipped.

A file that cannot be decoded raises an error naming it; nothing falls
back.
"""

import numpy as np

from qaig_tpu_torch import native
from qaig_tpu_torch.data.manifest import Manifest
from qaig_tpu_torch.utils import png

_JPEG = b"\xff\xd8\xff"


def _head(path):
    with open(path, "rb") as f:
        return f.read(8)


def _jpeg_bgr(path):
    """(H, W, 3) uint8 BGR pixels of a JPEG file, through PIL."""
    try:
        from PIL import Image
    except ImportError as e:
        raise IOError(f"{path}: JPEG needs PIL to decode, and PIL does "
                      f"not import ({e})") from e
    with Image.open(path) as image:
        rgb = np.asarray(image.convert("RGB"))
    return np.ascontiguousarray(rgb[:, :, ::-1])


def read_image(path):
    """(3, H, W) float32 BGR in [-1, 1] of a PNG (the native decoder) or
    JPEG (PIL) file."""
    head = _head(path)
    if head == png.SIGNATURE:
        return native.load_image(path)
    if head[:3] == _JPEG:
        image = (_jpeg_bgr(path).astype(np.float32) - 127.5) / 127.5
        return np.ascontiguousarray(image.transpose(2, 0, 1))
    raise IOError(f"Failed to read image: {path} (neither PNG nor JPEG)")


class ImageDataset:
    def __init__(self, dataset_path, return_filepaths=False):
        self.return_filepaths = return_filepaths
        self.manifest = Manifest(dataset_path)
        if len(self.manifest) == 0:
            raise ValueError("No data found.")
        self._item_shape = None

    def load_batch(self, indices, num_threads=4):
        """The batch's images as one (N, 3, H, W) float32 array, decoded by
        the native batch decoder over ``num_threads`` threads; ``None``
        (the loader then decodes item by item) where ``qaig_tpu``'s
        declines, with ``return_filepaths``, and for a batch that holds a
        JPEG (by its extension, as ``qaig_tpu`` tells).  A file that
        cannot be decoded, or is not the first item's size, raises an
        error naming it."""
        if self.return_filepaths:
            return None
        paths = [self.manifest[i]["image_fpath"] for i in indices]
        if any(p.lower().endswith((".jpg", ".jpeg")) for p in paths):
            return None
        if self._item_shape is None:
            self._item_shape = self[indices[0]].shape
        _, h, w = self._item_shape
        return native.load_image_batch(paths, h, w, num_threads)

    def __len__(self):
        return len(self.manifest)

    def __getitem__(self, index):
        path = self.manifest[index]["image_fpath"]
        image = read_image(path)
        if self.return_filepaths:
            return image, path
        return image
