"""The data plane of the PyTorch port (``qaig_tpu_torch/native``: the
batch loaders for ``.npy`` latents and PNG images, in C++ built with
``g++`` at first use) and the datasets and loader over it, against the
plain decoder (``utils/png.py``) and against ``qaig_tpu`` (its native
library and its cv2 datasets), on the CPU.

* ``load_image_batch``, ``ImageDataset.load_batch`` and an item are
  bit-equal to ``png.read_bgr`` and to ``qaig_tpu``'s ``ImageDataset``
  (``cv2.imread``) for every PNG kind of ``tests/test_torch_port_stages.py``
  and for hand-filtered files of each filter type and of all five;
* interlaced (Adam7) files written by ``png.encode(..., interlace=True)``,
  of every color type at bit depths 1, 8 and 16 and of sizes 1-9 and 33
  (so that some passes are empty): the plain decoder, the native batch
  and ``qaig_tpu``'s native batch (libpng) equal ``qaig_tpu``'s
  ``ImageDataset`` (``cv2.imread``);
* a corrupt file, a CRC error, an interlaced file whose passes are
  truncated, an unknown filter type and a file of another size raise
  ``IOError`` naming the file; a batch that holds a JPEG goes item by
  item;
* ``load_npy_batch``, ``FeatureMapDataset.load_batch`` and
  ``normalize_images`` equal ``np.load`` and ``qaig_tpu.native``; a wrong
  shape raises; the image-pairing items equal ``qaig_tpu``'s (HWC);
* the ``DataLoader`` over datasets with ``load_batch`` gives
  ``qaig_tpu``'s batches in its order, shuffled and not;
* four processes building into one empty directory each load the
  libraries and leave no ``.tmp`` file; a failed build raises with the
  compiler's output.

Pixels and latents are compared exactly (PNG is lossless; both sides
compute ``(x - 127.5) / 127.5`` in float32); a JPEG within 2 units
(PIL's IDCT against OpenCV's).
"""

import struct
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

from qaig_tpu_torch.utils import png

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_port_stages import PNG_KINDS, _write_kind  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def _jax_native():
    """``qaig_tpu.native``, loaded: it builds next to its source at import,
    through one ``.tmp`` path shared by every process, so a worker that
    loses that race to another retries once the winner's library is in
    place."""
    from qaig_tpu import native
    if not native.AVAILABLE:
        native._load()
    assert native.AVAILABLE
    return native


def _manifest(root, paths, key="image_fpath"):
    from qaig_tpu_torch.data.manifest import write_manifest
    return write_manifest(Path(root) / "d.json",
                          [{key: str(p), "labels": []} for p in paths])


def _plain(path):
    image = (png.read_bgr(path).astype(np.float32) - 127.5) / 127.5
    return np.ascontiguousarray(image.transpose(2, 0, 1))


def _png(raw, width, height, depth=8, color=2, interlace=0):
    """PNG bytes around the given filtered scanlines."""
    header = struct.pack(">IIBBBBB", width, height, depth, color, 0, 0,
                         interlace)
    return (png.SIGNATURE + png._chunk(b"IHDR", header)
            + png._chunk(b"IDAT", zlib.compress(raw))
            + png._chunk(b"IEND", b""))


# ---------------------------------------------------------------------------
# the PNG batch decoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", PNG_KINDS)
def test_png_batch_equals_plain_decoder_and_qaig_tpu(kind, tmp_path):
    from qaig_tpu.data import ImageDataset as JaxImageDataset
    from qaig_tpu_torch import native
    from qaig_tpu_torch.data.image_dataset import ImageDataset

    paths = []
    for i in range(3):
        path = tmp_path / f"{kind}_{i}.png"
        _write_kind(path, kind, np.random.default_rng(100 * i + len(kind)))
        paths.append(path)
    want = np.stack([_plain(p) for p in paths])
    manifest = _manifest(tmp_path, paths)
    ref = JaxImageDataset(manifest)
    np.testing.assert_array_equal(
        want, np.stack([ref[i] for i in range(3)]))
    for threads in (1, 4):
        got = native.load_image_batch(paths, 11, 13, num_threads=threads)
        assert got.dtype == np.float32 and got.shape == (3, 3, 11, 13)
        np.testing.assert_array_equal(got, want)
    dataset = ImageDataset(manifest)
    np.testing.assert_array_equal(dataset.load_batch([2, 0, 1]),
                                  want[[2, 0, 1]])
    np.testing.assert_array_equal(dataset[1], want[1])


@pytest.mark.parametrize("filters", [[0], [1], [2], [3], [4],
                                     [0, 1, 2, 3, 4], [4, 3, 4, 3, 1]],
                         ids=["none", "sub", "up", "average", "paeth",
                              "all_five", "mostly_paeth_average"])
def test_every_row_filter_equals_plain_decoder_and_cv2(filters, tmp_path):
    import cv2
    from qaig_tpu_torch import native

    rng = np.random.default_rng(len(filters) * 7 + filters[0])
    paths = []
    for i in range(4):
        # smooth fields with noise, as photographs are, and pure noise
        base = np.add.outer(np.arange(24), np.arange(40))[:, :, None]
        pixels = (base * (i + 1) + rng.integers(0, 40 * i + 1, (24, 40, 3)))
        path = tmp_path / f"{i}.png"
        path.write_bytes(png.encode((pixels % 256).astype(np.uint8),
                                       filters))
        paths.append(path)
    got = native.load_image_batch(paths, 24, 40, num_threads=3)
    want = np.stack([_plain(p) for p in paths])
    np.testing.assert_array_equal(got, want)
    cv = np.stack([((cv2.imread(str(p)).astype(np.float32) - 127.5)
                    / 127.5).transpose(2, 0, 1) for p in paths])
    np.testing.assert_array_equal(got, cv)


def test_item_goes_through_the_native_decoder(tmp_path, monkeypatch):
    """An item is a batch of one through the native library: the plain
    decoder is not called."""
    from qaig_tpu_torch.data.image_dataset import ImageDataset

    path = tmp_path / "a.png"
    path.write_bytes(png.encode(
        np.random.default_rng(0).integers(0, 256, (9, 7, 3), np.uint8),
        [4, 3]))
    want = _plain(path)

    def refuse(*a, **kw):
        raise AssertionError("the plain decoder ran")
    monkeypatch.setattr(png, "read_bgr", refuse)
    monkeypatch.setattr(png, "decode", refuse)
    image, got_path = ImageDataset(_manifest(tmp_path, [path]),
                                   return_filepaths=True)[0]
    assert got_path == str(path)
    np.testing.assert_array_equal(image, want)


# (color type, bit depth) of the Adam7 files: every color type, at the
# depths 1, 8 and 16 that it allows
ADAM7_KINDS = [(0, 1), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 8),
               (4, 8), (4, 16), (6, 8), (6, 16)]
# (height, width): every side 1-9 and 33, so that some passes are empty
ADAM7_SIZES = [(1, 1), (2, 9), (3, 5), (4, 2), (5, 33), (6, 7), (7, 3),
               (8, 8), (9, 4), (33, 6), (33, 33), (1, 33)]


def _samples(rng, color, depth, height, width):
    """(pixels, palette) of a random image of the kind."""
    if color == 3:
        k = min(1 << depth, 40)
        palette = rng.integers(0, 256, (k, 4 if width % 2 else 3), np.uint8)
        return rng.integers(0, k, (height, width), np.uint8), palette
    channels = {0: 1, 2: 3, 4: 2, 6: 4}[color]
    pixels = rng.integers(0, 1 << depth, (height, width, channels))
    return pixels.astype(np.uint16 if depth == 16 else np.uint8), None


@pytest.mark.parametrize("color,depth", ADAM7_KINDS,
                         ids=[f"color{c}_depth{d}" for c, d in ADAM7_KINDS])
def test_adam7_equals_cv2_and_qaig_tpu(color, depth, tmp_path):
    """Interlaced files of every size through the plain decoder, the native
    batch (beside a non-interlaced file of the same size) and the dataset's
    batches: ``cv2.imread``'s pixels (``qaig_tpu``'s ``ImageDataset``), bit
    for bit, and ``qaig_tpu``'s libpng batch's where it is built."""
    from qaig_tpu import native as jax_native
    from qaig_tpu.data import ImageDataset as JaxImageDataset
    from qaig_tpu_torch import native
    from qaig_tpu_torch.data.image_dataset import ImageDataset

    rng = np.random.default_rng(10 * color + depth)
    for height, width in ADAM7_SIZES:
        paths = []
        for interlace in (True, False, True):
            pixels, palette = _samples(rng, color, depth, height, width)
            path = tmp_path / f"{height}x{width}_{len(paths)}.png"
            path.write_bytes(png.encode(pixels, [4, 3, 1, 0, 2], interlace,
                                        depth, palette))
            paths.append(path)
        header = png.inflate(paths[0].read_bytes())[0]
        assert header == (width, height, depth, color, 1)
        manifest = _manifest(tmp_path, paths)
        want = np.stack([JaxImageDataset(manifest)[i] for i in range(3)])
        where = f"{height}x{width}"
        np.testing.assert_array_equal(
            np.stack([_plain(p) for p in paths]), want, err_msg=where)
        got = native.load_image_batch(paths, height, width, num_threads=2)
        np.testing.assert_array_equal(got, want, err_msg=where)
        np.testing.assert_array_equal(
            ImageDataset(manifest).load_batch([2, 0, 1]), want[[2, 0, 1]],
            err_msg=where)
        if jax_native.IMAGE_AVAILABLE:
            np.testing.assert_array_equal(
                jax_native.load_image_batch([str(p) for p in paths], height,
                                            width), want, err_msg=where)


@pytest.mark.parametrize("cut_pass", [1, 4, 7])
def test_truncated_adam7_pass_raises_naming_the_file(cut_pass, tmp_path):
    """An Adam7 file whose scanlines end inside pass ``cut_pass`` raises
    naming the file (and the pass) in the native batch and in the dataset;
    the plain decoder raises; the C++ side refuses such rows too."""
    from qaig_tpu_torch import native
    from qaig_tpu_torch.data.image_dataset import ImageDataset

    rgb = np.random.default_rng(cut_pass).integers(0, 256, (11, 13, 3),
                                                   np.uint8)
    _, _, _, raw = png.inflate(png.encode(rgb, [1, 4], interlace=True))
    end = sum(rows * (cols * 3 + 1) for number, *_, cols, rows in
              png.passes(13, 11, 1) if number <= cut_pass)
    short = _png(raw[:end - 1], 13, 11, interlace=1)
    message = f"truncated in pass {cut_pass}"
    with pytest.raises(ValueError, match=message):
        png.decode(short)
    good = tmp_path / "good.png"
    good.write_bytes(png.encode(rgb, interlace=True))
    bad = tmp_path / "short.png"
    bad.write_bytes(short)
    with pytest.raises(IOError, match=message) as err:
        native.load_image_batch([good, bad], 11, 13)
    assert str(bad) in str(err.value)
    with pytest.raises(IOError) as err:
        ImageDataset(_manifest(tmp_path, [good, bad])).load_batch([0, 1])
    assert str(bad) in str(err.value)
    with pytest.raises(IOError, match="image data truncated") as err:
        native._decode_png_batch([str(bad)], [((13, 11, 8, 2, 1), None,
                                               raw[:end - 1])], 11, 13, 1)
    assert str(bad) in str(err.value)


def _bad_files(root):
    """(name, bytes, message) of files the decoder must refuse."""
    rgb = np.random.default_rng(1).integers(0, 256, (11, 13, 3), np.uint8)
    good = png.encode(rgb, [0, 1, 2, 3, 4])
    _, _, _, raw = png.inflate(good)
    crc = bytearray(good)
    crc[45] ^= 1                          # inside IDAT's body
    bad_filter = bytearray(raw)
    bad_filter[0] = 5
    other = np.random.default_rng(2).integers(0, 256, (12, 13, 3), np.uint8)
    return [
        ("truncated", good[:60], "ends before IEND"),
        ("no_header", png.SIGNATURE + png._chunk(b"IEND", b""), "no IHDR"),
        ("crc", bytes(crc), "bad CRC"),
        # non-interlaced rows are 11 bytes short of Adam7's passes
        ("interlaced", _png(raw, 13, 11, interlace=1),
         r"interlaced \(Adam7\) PNG image data is truncated in pass 7"),
        ("filter", _png(bytes(bad_filter), 13, 11), "unknown row filter"),
        ("short_rows", _png(raw[:100], 13, 11), "truncated"),
        ("size", png.encode(other, [1]), "12x13, the batch is 11x13"),
    ]


@pytest.mark.parametrize("case", range(7),
                         ids=["truncated", "no_header", "crc", "interlaced",
                              "filter", "short_rows", "size"])
def test_bad_png_raises_naming_the_file(case, tmp_path):
    from qaig_tpu_torch import native
    from qaig_tpu_torch.data.image_dataset import ImageDataset
    from qaig_tpu_torch.data.loader import DataLoader

    name, data, message = _bad_files(tmp_path)[case]
    good = tmp_path / "good.png"
    good.write_bytes(png.encode(np.zeros((11, 13, 3), np.uint8), [0]))
    bad = tmp_path / f"{name}.png"
    bad.write_bytes(data)
    with pytest.raises(IOError, match=message) as err:
        native.load_image_batch([good, bad, good], 11, 13)
    assert str(bad) in str(err.value)
    dataset = ImageDataset(_manifest(tmp_path, [good, bad]))
    with pytest.raises(IOError) as err:
        dataset.load_batch([0, 1])
    assert str(bad) in str(err.value)
    with pytest.raises(IOError) as err:
        list(DataLoader(dataset, batch_size=2, shuffle=False))
    assert str(bad) in str(err.value)
    if name != "size":
        with pytest.raises(IOError) as err:
            dataset[1]
        assert str(bad) in str(err.value)


def test_missing_and_non_png_files_raise_naming_them(tmp_path):
    from qaig_tpu_torch import native
    missing = tmp_path / "missing.png"
    gif = tmp_path / "a.gif"
    gif.write_bytes(b"GIF89a" + bytes(40))
    for path in (missing, gif):
        with pytest.raises(IOError) as err:
            native.load_image_batch([path], 4, 4)
        assert str(path) in str(err.value)


def test_batch_holding_a_jpeg_goes_item_by_item(tmp_path):
    from PIL import Image
    from qaig_tpu.data import ImageDataset as JaxImageDataset
    from qaig_tpu_torch.data.image_dataset import ImageDataset
    from qaig_tpu_torch.data.loader import DataLoader

    rng = np.random.default_rng(3)
    paths = []
    for i in range(3):
        path = tmp_path / f"{i}.png"
        path.write_bytes(png.encode(
            rng.integers(0, 256, (16, 16, 3), np.uint8), [4, 3]))
        paths.append(path)
    ramp = np.add.outer(np.arange(16), np.arange(16))[:, :, None]
    Image.fromarray((ramp * np.array([3, 5, 7]) % 256).astype(np.uint8)) \
        .save(tmp_path / "j.jpg", quality=90)
    paths.insert(1, tmp_path / "j.jpg")
    manifest = _manifest(tmp_path, paths)
    dataset = ImageDataset(manifest)
    assert dataset.load_batch([0, 1, 2]) is None
    assert dataset.load_batch([0, 2, 3]) is not None
    (batch,) = list(DataLoader(dataset, batch_size=4, shuffle=False))
    np.testing.assert_array_equal(batch, np.stack([dataset[i]
                                                   for i in range(4)]))
    ref = JaxImageDataset(manifest)
    for i in (0, 2, 3):
        np.testing.assert_array_equal(batch[i], ref[i])
    assert np.abs(batch[1] - ref[1]).max() <= 2 / 127.5 + 1e-6


def test_load_batch_declines_with_filepaths(tmp_path):
    from qaig_tpu_torch.data.image_dataset import ImageDataset
    path = tmp_path / "a.png"
    path.write_bytes(png.encode(np.zeros((4, 4, 3), np.uint8), [0]))
    assert ImageDataset(_manifest(tmp_path, [path]),
                        return_filepaths=True).load_batch([0]) is None


# ---------------------------------------------------------------------------
# .npy batches and the feature-map dataset
# ---------------------------------------------------------------------------

def _write_fmaps(root, n=7, shape=(4, 6, 5), seed=5, images=False):
    """Latents written as the fmap stage writes them (``np.save`` to a
    path with no suffix), with paired PNGs when ``images``."""
    from qaig_tpu_torch.data.manifest import write_manifest
    root = Path(root)
    rng = np.random.default_rng(seed)
    rows, arrays = [], []
    for i in range(n):
        x = rng.standard_normal(shape).astype(np.float32)
        path = root / f"f{i}"
        with open(path, "wb") as f:
            np.save(f, x, allow_pickle=False)
        image = ""
        if images:
            image = root / f"i{i}.png"
            image.write_bytes(png.encode(
                rng.integers(0, 256, (9, 10, 3), np.uint8), [i % 5, 4]))
        rows.append({"fmap_path": str(path), "image_path": str(image)})
        arrays.append(x)
    return write_manifest(root / "all_dataset.json", rows), rows, arrays


@pytest.mark.parametrize("threads", [1, 3, 16])
def test_npy_batch_equals_np_load_and_qaig_tpu(threads, tmp_path):
    from qaig_tpu_torch import native
    _, rows, arrays = _write_fmaps(tmp_path)
    paths = [r["fmap_path"] for r in rows]
    got = native.load_npy_batch(paths, (4, 6, 5), num_threads=threads)
    np.testing.assert_array_equal(got, np.stack(arrays))
    np.testing.assert_array_equal(
        got, _jax_native().load_npy_batch(paths, (4, 6, 5)))


def test_npy_wrong_shape_dtype_or_file_raises(tmp_path):
    from qaig_tpu_torch import native
    _, rows, _ = _write_fmaps(tmp_path, n=2)
    paths = [r["fmap_path"] for r in rows]
    wide = tmp_path / "wide"
    with open(wide, "wb") as f:
        np.save(f, np.zeros((4, 6, 6), np.float32))
    doubles = tmp_path / "doubles"
    with open(doubles, "wb") as f:
        np.save(f, np.zeros((4, 6, 5), np.float64))
    for bad in (wide, doubles, tmp_path / "missing"):
        with pytest.raises(IOError) as err:
            native.load_npy_batch([paths[0], str(bad), paths[1]], (4, 6, 5))
        assert str(bad) in str(err.value)
    with pytest.raises(IOError, match="f0"):
        native.load_npy_batch(paths, (4, 6, 4))


def test_fmap_dataset_load_batch_equals_items_and_qaig_tpu(tmp_path):
    from qaig_tpu.data.fmap_dataset import FeatureMapDataset as JaxFmaps
    from qaig_tpu_torch.data.fmap_dataset import FeatureMapDataset

    manifest, _, arrays = _write_fmaps(tmp_path)
    _jax_native()
    dataset = FeatureMapDataset(manifest)
    got = dataset.load_batch([5, 0, 3])
    np.testing.assert_array_equal(got, np.stack([arrays[i]
                                                 for i in (5, 0, 3)]))
    np.testing.assert_array_equal(got, JaxFmaps(manifest).load_batch(
        [5, 0, 3]))
    for flags in ({"load_image": True}, {"return_filepaths": True}):
        assert FeatureMapDataset(manifest, **flags).load_batch([0]) is None


@pytest.mark.parametrize("filepaths", [False, True])
def test_fmap_dataset_with_images_equals_qaig_tpu_hwc(filepaths, tmp_path):
    from qaig_tpu.data.fmap_dataset import FeatureMapDataset as JaxFmaps
    from qaig_tpu_torch.data.fmap_dataset import FeatureMapDataset

    manifest, rows, _ = _write_fmaps(tmp_path, images=True)
    flags = dict(load_image=True, return_filepaths=filepaths)
    port, ref = FeatureMapDataset(manifest, **flags), JaxFmaps(manifest,
                                                               **flags)
    for i in range(len(rows)):
        got, want = port[i], ref[i]
        assert len(got) == len(want) == (4 if filepaths else 2)
        for a, b in zip(got, want):
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype == np.float32
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b
        image = got[2 if filepaths else 1]
        assert image.shape == (9, 10, 3)   # HWC, the reference's quirk


def test_normalize_images_equals_qaig_tpu():
    from qaig_tpu_torch import native
    batch = np.random.default_rng(4).integers(0, 256, (3, 5, 7, 3),
                                              dtype=np.uint8)
    got = native.normalize_images(batch)
    assert got.shape == (3, 3, 5, 7) and got.dtype == np.float32
    np.testing.assert_array_equal(got,
                                  _jax_native().normalize_images(batch))
    np.testing.assert_allclose(
        got, ((batch.astype(np.float32) - 127.5) / 127.5).transpose(
            0, 3, 1, 2), atol=1e-6)


# ---------------------------------------------------------------------------
# the loader over load_batch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("what", ["images", "fmaps"])
def test_loader_over_load_batch_matches_qaig_tpu(what, shuffle, tmp_path,
                                                 monkeypatch):
    """Two epochs of each loader: the same batches in the same order, the
    port's from ``load_batch`` (counted), ragged last batch kept."""
    from qaig_tpu.data import DataLoader as JaxLoader
    from qaig_tpu.data import ImageDataset as JaxImageDataset
    from qaig_tpu.data.fmap_dataset import FeatureMapDataset as JaxFmaps
    from qaig_tpu_torch.data.fmap_dataset import FeatureMapDataset
    from qaig_tpu_torch.data.image_dataset import ImageDataset
    from qaig_tpu_torch.data.loader import DataLoader

    if what == "images":
        rng = np.random.default_rng(6)
        paths = []
        for i in range(11):
            path = tmp_path / f"{i}.png"
            path.write_bytes(png.encode(
                rng.integers(0, 256, (8, 12, 3), np.uint8), [i % 5, 3, 4]))
            paths.append(path)
        manifest = _manifest(tmp_path, paths)
        port, ref = ImageDataset(manifest), JaxImageDataset(manifest)
    else:
        manifest, _, _ = _write_fmaps(tmp_path, n=11)
        _jax_native()
        port, ref = FeatureMapDataset(manifest), JaxFmaps(manifest)
    calls = []
    load_batch = port.load_batch
    monkeypatch.setattr(port, "load_batch", lambda idx, num_threads: (
        calls.append(num_threads) or load_batch(idx, num_threads)))
    kw = dict(batch_size=4, shuffle=shuffle, seed=9, drop_remainder=False)
    mine, theirs = DataLoader(port, **kw), JaxLoader(ref, **kw)
    assert (mine.prefetch, mine.num_workers) == (2, 4)
    for _ in range(2):
        got, want = list(mine), list(theirs)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert calls == [4] * 6    # num_workers threads decode each batch
    single = DataLoader(port, prefetch=1, num_workers=1, **kw)
    for g, w in zip(list(single), list(JaxLoader(ref, **kw))):
        np.testing.assert_array_equal(g, w)
    assert calls == [4] * 6 + [1] * 3


# ---------------------------------------------------------------------------
# the build
# ---------------------------------------------------------------------------

BUILD_ONE = """
import sys
from pathlib import Path
import numpy as np
from qaig_tpu_torch import native
native.BUILD_DIR = Path(sys.argv[1])
out = native.normalize_images(np.full((1, 2, 2, 3), 255, np.uint8))
image = native.load_image(sys.argv[2])
assert out.max() == 1.0 and image.shape == (3, 4, 4)
print("loaded", sorted(p.name for p in native.BUILD_DIR.iterdir()))
"""


def test_four_processes_build_into_one_empty_directory(tmp_path):
    from qaig_tpu_torch import native

    build = tmp_path / "build"
    image = tmp_path / "a.png"
    image.write_bytes(png.encode(np.zeros((4, 4, 3), np.uint8)))
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_ONE, str(build),
                               str(image)], cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, outs
    assert all("loaded" in out for out in outs), outs
    names = sorted(p.name for p in build.iterdir())
    assert names == sorted([native.library_path("npy_loader").name,
                            native.library_path("image_loader").name])
    assert not any(name.endswith(".tmp") for name in names)


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    from qaig_tpu_torch import native
    (tmp_path / "broken.cpp").write_text("int f() { return undeclared; }\n")
    monkeypatch.setattr(native, "SOURCE_DIR", tmp_path)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for broken.cpp"
                       "(.|\\n)*undeclared"):
        native.build("broken")
    assert not any(p.name.endswith(".tmp")
                   for p in (tmp_path / "build").iterdir())
