"""Image grid writer (counterpart of ``qaig_tpu/utils/image_io.py``).

Channels are flipped BGR->RGB, tiled into an ``nrow``-wide grid with 2px
padding, normalized from (-1, 1) to [0, 1], and written as
``<dest>/images/<name>.jpg``.  PIL is imported only when an image is saved;
without it ``save_images`` logs and returns False, as on any error.
"""

import os

import numpy as np


def make_grid(images, nrow=5, padding=2, value_range=(-1.0, 1.0)):
    """(N, C, H, W) float -> (H', W', C) float grid in [0, 1]."""
    images = np.asarray(images)
    lo, hi = value_range
    images = np.clip((images - lo) / max(hi - lo, 1e-5), 0.0, 1.0)

    n, c, h, w = images.shape
    ncol = min(nrow, n)
    nrows = (n + ncol - 1) // ncol
    grid_h = nrows * (h + padding) + padding
    grid_w = ncol * (w + padding) + padding
    grid = np.zeros((c, grid_h, grid_w), images.dtype)
    for idx in range(n):
        r, col = divmod(idx, ncol)
        y = padding + r * (h + padding)
        x = padding + col * (w + padding)
        grid[:, y:y + h, x:x + w] = images[idx]
    return grid.transpose(1, 2, 0)


def save_images(images, file_name, dest_path, nrow=5, logging=print):
    """Save a BGR (N, C, H, W) batch as an RGB jpg grid; returns bool."""
    try:
        from PIL import Image
        images = np.asarray(images)
        images = images[:, [2, 1, 0]]  # BGR -> RGB
        grid = make_grid(images, nrow=nrow)
        grid_u8 = np.clip(grid * 255.0 + 0.5, 0, 255).astype(np.uint8)

        dir_path = os.path.join(str(dest_path), "images")
        os.makedirs(dir_path, exist_ok=True)
        path = os.path.join(dir_path, str(file_name) + ".jpg")
        Image.fromarray(grid_u8).save(path)
        logging(f"Saving image: {path}")
        return True
    except Exception as e:
        logging(f"An error occured while saving image: {e}")
        return False
