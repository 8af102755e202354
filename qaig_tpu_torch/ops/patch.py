"""Patchify / unpatchify in the reference's index order (counterpart of
``qaig_tpu/ops/patch.py``).

Patches are enumerated row-major over the (H/pH, W/pW) grid and each patch
is flattened in (C, pH, pW) order: a token at sequence position ``s`` refers
to patch ``(s // nW, s % nW)`` of the latent image.  NCHW throughout.
"""


def patchify(image, patch_dim=(4, 4)):
    """(N, C, H, W) -> (N, (H/pH)*(W/pW), C*pH*pW)."""
    patch_h, patch_w = patch_dim
    n, c, h, w = image.shape
    new_h = h // patch_h
    new_w = w // patch_w
    patches = image.reshape(n, c, new_h, patch_h, new_w, patch_w)
    patches = patches.permute(0, 2, 4, 1, 3, 5)  # (N, nH, nW, C, pH, pW)
    return patches.reshape(n, new_h * new_w, c * patch_h * patch_w)


def unpatchify(patches, image_dim=(32, 32), patch_dim=(4, 4)):
    """(N, Seq, D) -> (N, D/(pH*pW), H, W); exact inverse of
    :func:`patchify`."""
    image_h, image_w = image_dim
    patch_h, patch_w = patch_dim
    n, _, d = patches.shape
    new_h = image_h // patch_h
    new_w = image_w // patch_w
    c = d // (patch_h * patch_w)
    patches = patches.reshape(n, new_h, new_w, c, patch_h, patch_w)
    patches = patches.permute(0, 3, 1, 4, 2, 5)  # (N, C, nH, pH, nW, pW)
    return patches.reshape(n, c, patch_h * new_h, patch_w * new_w)
