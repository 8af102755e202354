"""The data plane's native library (counterpart of ``qaig_tpu/native``):
batch loaders for ``.npy`` latents and PNG images, in C++ for the host.

Two sources, each its own shared library: ``npy_loader.cpp`` (a copy of
``qaig_tpu``'s: ``.npy`` batches over a thread pool, and the fused
uint8 -> [-1, 1] normalisation) and ``image_loader.cpp`` (PNG row
filters, sample expansion and normalisation into one CHW slab).  Neither
links anything but the C++ standard library and pthreads.

Each source is compiled by ``g++ -O3 -shared -fPIC -std=c++17 -pthread``
at its first use (nothing runs at import) into ``build/
qaig_tpu_torch_native/`` at the repository root (listed in
``.gitignore``), named by a hash of the source and the flags, so a
checkout builds it once and reuses it.  The compiler writes to
``<target>.<pid>.tmp`` and the file is then renamed into place, so
processes that build at once (``pytest -n 6``) each load a whole library.
A failed build raises with the compiler's output; there is no fallback.

PNG decoding is split between Python and C++: Python reads each file,
checks its chunks' CRCs and its header, and inflates the image data with
``zlib`` (``utils/png.py::inflate``; ``zlib`` releases the GIL, and the
files are read on ``num_threads`` threads); the C++ side undoes the five
row filters, walks an interlaced (Adam7) file's seven passes, expands the
samples and normalises the whole batch over ``num_threads`` threads (a
ctypes call releases the GIL).  The pixels equal
``utils/png.py::read_bgr``'s, which are ``cv2.imread``'s, interlaced
files' too.
"""

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from qaig_tpu_torch.utils import png

SOURCE_DIR = Path(__file__).resolve().parent
BUILD_DIR = (Path(__file__).resolve().parents[2] / "build"
             / "qaig_tpu_torch_native")
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_FLOAT_P = ctypes.POINTER(ctypes.c_float)
_SIGNATURES = {
    "npy_loader": {
        "qaig_load_npy_batch": (ctypes.c_int, [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, _FLOAT_P,
            ctypes.c_long, ctypes.c_int]),
        "qaig_normalize_images": (None, [
            ctypes.POINTER(ctypes.c_ubyte), _FLOAT_P, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int]),
    },
    "image_loader": {
        "qaig_decode_png_batch": (ctypes.c_int, [
            ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int32),
            _FLOAT_P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32)]),
    },
}
# image_loader.cpp's per-image status codes
_BAD_SIZE = 4
_PNG_ERRORS = {1: "image data truncated", 2: "unknown row filter type",
               3: "palette index past the PLTE entries",
               5: "color type and bit depth that PNG does not allow"}

_lock = threading.Lock()
_libraries = {}


def library_path(name):
    """Where the library of ``<name>.cpp`` is built: named by a hash of
    the source and the flags."""
    digest = hashlib.sha256((SOURCE_DIR / f"{name}.cpp").read_bytes())
    digest.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name):
    """Compile ``<name>.cpp`` unless its library exists; returns the
    library's path.  Raises with ``g++``'s output if the build fails."""
    target = library_path(name)
    if target.exists():
        return target
    compiler = shutil.which("g++")
    if compiler is None:
        raise RuntimeError(
            f"g++ not found: the data plane's {name}.cpp is compiled at "
            f"first use and needs a C++ compiler on the PATH.")
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [compiler, *FLAGS, str(SOURCE_DIR / f"{name}.cpp"), "-o", str(tmp)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {name}.cpp:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, target)
    return target


def _function(name, symbol):
    """The C entry point ``symbol`` of library ``name`` (built at first
    use), its ctypes signature set."""
    with _lock:
        lib = _libraries.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            for sym, (restype, argtypes) in _SIGNATURES[name].items():
                getattr(lib, sym).restype = restype
                getattr(lib, sym).argtypes = argtypes
            _libraries[name] = lib
    return getattr(lib, symbol)


def load_npy_batch(paths, item_shape, num_threads=4):
    """Load ``len(paths)`` float32 ``.npy`` files of ``item_shape`` into
    one (N, *item_shape) array over the native thread pool.  A file that
    cannot be read, or holds another dtype or size, raises ``IOError``
    naming it."""
    n = len(paths)
    out = np.empty((n,) + tuple(item_shape), np.float32)
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    rc = _function("npy_loader", "qaig_load_npy_batch")(
        arr, n, out.ctypes.data_as(_FLOAT_P), int(np.prod(item_shape)),
        num_threads)
    if rc != 0:
        raise IOError(f"native npy batch load failed on {paths[rc - 100]}")
    return out


def normalize_images(batch_u8):
    """(N, H, W, C) uint8 BGR -> (N, C, H, W) float32 in [-1, 1]."""
    n, h, w, c = batch_u8.shape
    batch_u8 = np.ascontiguousarray(batch_u8, np.uint8)
    out = np.empty((n, c, h, w), np.float32)
    _function("npy_loader", "qaig_normalize_images")(
        batch_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        out.ctypes.data_as(_FLOAT_P), n, h, w, c)
    return out


def _read_png(path):
    """(header (width, height, depth, color, interlace), palette, inflated
    rows) of one file; any fault (a truncated pass among them) raises
    ``IOError`` naming it."""
    try:
        with open(path, "rb") as f:
            data = f.read()
        header, palette, _, raw = png.inflate(data)
    except (OSError, ValueError, struct.error, zlib.error) as e:
        raise IOError(f"native PNG batch load failed on {path}: {e}") from e
    return header, palette, raw


def _decode_png_batch(paths, files, height, width, num_threads):
    """The C++ half: ``files`` (``_read_png``'s, one a path) into one
    (N, 3, height, width) float32 slab."""
    n = len(files)
    out = np.empty((n, 3, height, width), np.float32)
    data = (ctypes.c_void_p * n)()
    sizes = (ctypes.c_int64 * n)()
    headers = (ctypes.c_int32 * (5 * n))()
    palettes = (ctypes.c_void_p * n)()
    entries = (ctypes.c_int32 * n)()
    errors = (ctypes.c_int32 * n)()
    keep = []   # the buffers the pointers point into, alive for the call
    for i, (header, palette, raw) in enumerate(files):
        buf = np.frombuffer(raw, np.uint8)
        keep.append(buf)
        data[i] = buf.ctypes.data
        sizes[i] = buf.size
        headers[5 * i:5 * i + 5] = list(header)
        if palette is not None:
            palette = np.ascontiguousarray(palette, np.uint8)
            keep.append(palette)
            palettes[i] = palette.ctypes.data
            entries[i] = palette.shape[0]
    rc = _function("image_loader", "qaig_decode_png_batch")(
        n, data, sizes, headers, palettes, entries,
        out.ctypes.data_as(_FLOAT_P), height, width, num_threads, errors)
    if rc != 0:
        i = rc - 100
        why = _PNG_ERRORS.get(errors[i], errors[i])
        if errors[i] == _BAD_SIZE:
            width_i, height_i = files[i][0][:2]
            why = f"{height_i}x{width_i}, the batch is {height}x{width}"
        raise IOError(f"native PNG batch load failed on {paths[i]}: {why}")
    return out


def load_image_batch(paths, height, width, num_threads=4):
    """Decode ``len(paths)`` PNG files of exactly (height, width) into one
    (N, 3, H, W) float32 BGR batch in [-1, 1] (``cv2.imread``'s pixels,
    ``(x - 127.5) / 127.5``), interlaced or not.  A file that is not a
    readable PNG of that size raises ``IOError`` naming it; JPEG is not
    taken here."""
    paths = [str(p) for p in paths]
    threads = max(1, min(num_threads, len(paths)))
    if threads > 1:
        with ThreadPoolExecutor(max_workers=threads) as pool:
            files = list(pool.map(_read_png, paths))
    else:
        files = [_read_png(p) for p in paths]
    return _decode_png_batch(paths, files, height, width, threads)


def load_image(path):
    """One PNG file of any size -> (3, H, W) float32 BGR in [-1, 1]: a
    batch of one through the same decoder."""
    path = str(path)
    file = _read_png(path)
    width, height = file[0][:2]
    return _decode_png_batch([path], [file], height, width, 1)[0]
