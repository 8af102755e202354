"""PNG encoder and decoder, standard library only (``zlib`` + ``struct``).

:func:`encode` writes 8-bit gray or RGB with one zlib stream (the server's
images and test fixtures), filter 0 on every row unless given the rows'
filters.  :func:`decode`
reads every non-interlaced PNG of bit depth 1-16: gray, gray + alpha,
RGB, RGBA and palette images, all five row filters; interlaced (Adam7)
files raise.  :func:`read_bgr` gives what ``cv2.imread(path)`` gives:
(H, W, 3) uint8 BGR, gray repeated over three channels, alpha dropped,
16-bit samples cut to their high byte, 1/2/4-bit gray scaled to 0-255.

The filters Average and Paeth run in a Python loop per byte, so decoding
such images is slow (tens of ms for 128 x 128 x 3); filters None, Sub and
Up are vectorised.  :func:`decode` is the plain version of the data
plane's batch decoder (``native/image_loader.cpp``), which takes
:func:`inflate`'s output and undoes the filters in C++.
"""

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}   # by color type


def _chunk(tag, data):
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode(pixels, filters=(0,)):
    """(H, W) or (H, W, 1 | 3) uint8 gray / RGB -> PNG bytes.  Row ``y``
    uses filter ``filters[y % len(filters)]`` (0 None, 1 Sub, 2 Up, 3
    Average, 4 Paeth)."""
    pixels = np.asarray(pixels, np.uint8)
    if pixels.ndim == 2:
        pixels = pixels[:, :, None]
    height, width, channels = pixels.shape
    raw = np.ascontiguousarray(pixels).reshape(height, -1).astype(np.int64)
    rows = np.empty((height, raw.shape[1] + 1), np.uint8)
    for y in range(height):
        kind = filters[y % len(filters)]
        row = raw[y]
        up = raw[y - 1] if y else np.zeros_like(row)
        left = np.concatenate([np.zeros(channels, np.int64), row[:-channels]])
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = up
        elif kind == 3:
            pred = (left + up) // 2
        elif kind == 4:
            upleft = np.concatenate([np.zeros(channels, np.int64),
                                     up[:-channels]])
            est = left + up - upleft
            pa, pb, pc = abs(est - left), abs(est - up), abs(est - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, upleft))
        else:
            raise ValueError(f"PNG filter type {kind}: 0-4 only")
        rows[y, 0] = kind
        rows[y, 1:] = (row - pred) % 256
    header = struct.pack(">IIBBBBB", width, height, 8,
                         {1: 0, 3: 2}[channels], 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + _chunk(b"IEND", b""))


def _chunks(data):
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        if pos + 12 + length > len(data):
            break
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:
                                          pos + 12 + length])
        if zlib.crc32(tag + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {tag!r}: bad CRC")
        yield tag, body
        if tag == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG file ends before IEND")


def _unfilter(raw, height, stride, bpp):
    """Undo the row filters: raw has one filter byte before each row."""
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        start = y * (stride + 1)
        kind = raw[start]
        row = np.frombuffer(raw, np.uint8, stride, start + 1).copy()
        if kind == 1:     # Sub: a running sum per byte lane
            lanes = row.reshape(-1, bpp).astype(np.uint32)
            row = (np.cumsum(lanes, axis=0) & 255).astype(np.uint8).ravel()
        elif kind == 2:   # Up
            row += prev
        elif kind in (3, 4):
            row = bytearray(row.tobytes())
            up = prev.tobytes()
            for i in range(stride):
                a = row[i - bpp] if i >= bpp else 0
                b = up[i]
                if kind == 3:   # Average
                    pred = (a + b) >> 1
                else:           # Paeth
                    c = up[i - bpp] if i >= bpp else 0
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                row[i] = (row[i] + pred) & 255
            row = np.frombuffer(bytes(row), np.uint8)
        elif kind != 0:
            raise ValueError(f"PNG row {y}: unknown filter type {kind}")
        out[y] = row
        prev = out[y]
    return out


def inflate(data):
    """PNG bytes -> ((width, height, bit depth, color type), PLTE entries
    (K, 3) uint8 or None, tRNS bytes or None, the inflated scanlines: a
    filter byte before each row).  Checks every chunk's CRC and the header;
    interlaced files, and data too short for the rows, raise."""
    header, palette, alpha, idat = None, None, None, []
    for tag, body in _chunks(data):
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"tRNS":
            alpha = np.frombuffer(body, np.uint8)
        elif tag == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG file has no IHDR")
    width, height, depth, color, _, _, interlace = header
    if interlace:
        raise ValueError("interlaced PNG files are not supported")
    if color not in _CHANNELS or depth not in (1, 2, 4, 8, 16):
        raise ValueError(f"PNG color type {color}, bit depth {depth}")
    raw = zlib.decompress(b"".join(idat))
    if len(raw) < height * (_stride(width, depth, color) + 1):
        raise ValueError("PNG image data is truncated")
    return (width, height, depth, color), palette, alpha, raw


def _stride(width, depth, color):
    return (width * depth * _CHANNELS[color] + 7) // 8


def decode(data):
    """PNG bytes -> (H, W, C) samples: uint8 for bit depths up to 8 (1/2/4-
    bit gray scaled to 0-255, palette indices expanded to RGB, or RGBA
    when the palette has transparency), uint16 for 16-bit files; C is 1
    gray, 2 gray + alpha, 3 RGB, 4 RGBA."""
    (width, height, depth, color), palette, alpha, raw = inflate(data)
    channels = _CHANNELS[color]
    bits = depth * channels
    rows = _unfilter(raw, height, _stride(width, depth, color),
                     max(1, bits // 8))
    if depth == 16:
        return rows.view(">u2").reshape(height, width, channels).astype(
            np.uint16)
    if depth < 8:
        rows = np.unpackbits(rows, axis=1).reshape(height, -1, depth)
        rows = (rows * (1 << np.arange(depth - 1, -1, -1))).sum(-1)
        rows = rows[:, :width].astype(np.uint8)
        if color == 0:
            rows = rows * np.uint8(255 // ((1 << depth) - 1))
    pixels = rows.reshape(height, width, channels)
    if color == 3:
        if palette is None:
            raise ValueError("palette PNG without PLTE")
        index = pixels[:, :, 0]
        if alpha is None:
            return palette[index]
        full = np.full(len(palette), 255, np.uint8)
        full[:len(alpha)] = alpha[:len(palette)]
        return np.concatenate([palette[index], full[index][:, :, None]], -1)
    return pixels


def read_bgr(path):
    """``cv2.imread(path)`` for a PNG file: (H, W, 3) uint8 BGR."""
    with open(path, "rb") as f:
        pixels = decode(f.read())
    if pixels.dtype == np.uint16:
        pixels = (pixels >> 8).astype(np.uint8)
    if pixels.shape[2] <= 2:   # gray, gray + alpha
        return np.repeat(pixels[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(pixels[:, :, 2::-1])
