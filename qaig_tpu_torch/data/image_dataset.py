"""Image dataset over a TinyDB-format manifest (counterpart of
``qaig_tpu/data/image_dataset.py``).

The pixel semantics are ``qaig_tpu``'s (``cv2.imread``): BGR channel
order, scaled to [-1, 1] by ``(x - 127.5) / 127.5``, CHW float32.  The port
does not need OpenCV:

* PNG goes through the port's own decoder (``utils/png.py``), which reads
  what ``cv2.imread`` reads (gray repeated over three channels, alpha
  dropped, 16-bit samples cut to their high byte).  PNG is lossless, so
  the arrays equal ``qaig_tpu``'s exactly.
* JPEG goes through PIL.  PIL's libjpeg and OpenCV's may round the IDCT
  differently, so a decoded JPEG can differ from ``qaig_tpu``'s by a unit
  here and there (``qaig_tpu`` says the same of its own native loader).
  Without PIL a JPEG raises an error naming the missing decoder; it is
  never skipped.

``qaig_tpu``'s native batch decoder (``load_batch``) is not part of the
port: items are decoded one by one on the loader's threads.
"""

import numpy as np

from qaig_tpu_torch.data.manifest import Manifest
from qaig_tpu_torch.utils import png


def read_bgr(path):
    """(H, W, 3) uint8 BGR pixels of a PNG or JPEG file."""
    with open(path, "rb") as f:
        head = f.read(8)
    if head == png.SIGNATURE:
        return png.read_bgr(path)
    if head[:3] == b"\xff\xd8\xff":
        try:
            from PIL import Image
        except ImportError as e:
            raise IOError(f"{path}: JPEG needs PIL to decode, and PIL does "
                          f"not import ({e})") from e
        with Image.open(path) as image:
            rgb = np.asarray(image.convert("RGB"))
        return np.ascontiguousarray(rgb[:, :, ::-1])
    raise IOError(f"Failed to read image: {path} (neither PNG nor JPEG)")


class ImageDataset:
    def __init__(self, dataset_path, return_filepaths=False):
        self.return_filepaths = return_filepaths
        self.manifest = Manifest(dataset_path)
        if len(self.manifest) == 0:
            raise ValueError("No data found.")

    def __len__(self):
        return len(self.manifest)

    def __getitem__(self, index):
        path = self.manifest[index]["image_fpath"]
        image = (read_bgr(path).astype(np.float32) - 127.5) / 127.5
        image = np.ascontiguousarray(image.transpose(2, 0, 1))   # CHW
        if self.return_filepaths:
            return image, path
        return image
