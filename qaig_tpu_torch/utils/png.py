"""PNG encoder and decoder, standard library only (``zlib`` + ``struct``).

:func:`encode` writes gray, gray + alpha, RGB, RGBA or palette images at
any bit depth PNG allows, with one zlib stream (the server's images and
test fixtures), filter 0 on every row unless given the rows' filters,
and interlaced (Adam7) on request.  :func:`decode` reads every PNG of
bit depth 1-16: gray, gray + alpha, RGB, RGBA and palette images, all
five row filters, interlaced or not (an Adam7 file's seven passes are
unfiltered one by one and scattered into the image, as libpng's
``png_read_image`` does).  :func:`read_bgr` gives what
``cv2.imread(path)`` gives:
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


# Adam7's seven passes: (first row, first column, row step, column step)
ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
         (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))


def passes(width, height, interlace):
    """(pass number, first row, first column, row step, column step,
    columns, rows) of each non-empty pass: the whole image (pass 1) when
    ``interlace`` is 0, else those of Adam7's passes 1-7 that hold a
    pixel."""
    out = []
    for number, (y0, x0, dy, dx) in enumerate(
            ADAM7 if interlace else ((0, 0, 1, 1),), 1):
        cols = (width - x0 + dx - 1) // dx if width > x0 else 0
        rows = (height - y0 + dy - 1) // dy if height > y0 else 0
        if cols and rows:
            out.append((number, y0, x0, dy, dx, cols, rows))
    return out


def _pack(samples, depth):
    """(h, w, c) samples -> (h, stride) uint8 scanline bytes."""
    h = samples.shape[0]
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return samples.astype(np.uint8).reshape(h, -1)
    bits = (samples[:, :, :1].astype(np.uint8)
            >> np.arange(depth - 1, -1, -1, dtype=np.uint8)) & 1
    return np.packbits(bits.reshape(h, -1), axis=1)


def _filter(raw, bpp, kinds):
    """(h, stride) bytes -> (h, 1 + stride) scanlines: a filter byte and
    the filtered row, row ``y`` with filter ``kinds[y]``."""
    raw = raw.astype(np.int64)
    h, stride = raw.shape
    rows = np.empty((h, stride + 1), np.uint8)
    zeros = np.zeros(bpp, np.int64)
    for y in range(h):
        kind, row = kinds[y], raw[y]
        up = raw[y - 1] if y else np.zeros_like(row)
        left = np.concatenate([zeros, row])[:stride]
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = up
        elif kind == 3:
            pred = (left + up) // 2
        elif kind == 4:
            upleft = np.concatenate([zeros, up])[:stride]
            est = left + up - upleft
            pa, pb, pc = abs(est - left), abs(est - up), abs(est - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, upleft))
        else:
            raise ValueError(f"PNG filter type {kind}: 0-4 only")
        rows[y, 0] = kind
        rows[y, 1:] = (row - pred) % 256
    return rows


def encode(pixels, filters=(0,), interlace=False, depth=8, palette=None):
    """(H, W) or (H, W, C) samples -> PNG bytes: C 1 gray, 2 gray + alpha,
    3 RGB, 4 RGBA, of ``depth`` bits (1, 2, 4 or 8 for gray, values below
    ``2 ** depth``; 16 takes uint16 samples).  With ``palette`` ((K, 3)
    RGB, or (K, 4) RGBA, whose alpha is written as tRNS) the (H, W)
    samples are palette indices of ``depth`` 1-8.  Scanline ``i`` of the
    file (counted over every pass when interlaced) uses filter
    ``filters[i % len(filters)]`` (0 None, 1 Sub, 2 Up, 3 Average, 4
    Paeth); ``interlace`` writes Adam7's seven passes."""
    pixels = np.asarray(pixels)
    if pixels.ndim == 2:
        pixels = pixels[:, :, None]
    height, width, channels = pixels.shape
    color = 3 if palette is not None else {1: 0, 2: 4, 3: 2, 4: 6}[channels]
    if channels != _CHANNELS[color] or depth not in (
            (1, 2, 4, 8, 16) if color == 0 else (1, 2, 4, 8) if color == 3
            else (8, 16)):
        raise ValueError(f"PNG color type {color}, bit depth {depth}")
    bpp = max(1, depth * channels // 8)
    scanlines, count = [], 0
    for _, y0, x0, dy, dx, _, rows in passes(width, height, interlace):
        kinds = [filters[(count + y) % len(filters)] for y in range(rows)]
        scanlines.append(_filter(_pack(pixels[y0::dy, x0::dx], depth), bpp,
                                 kinds).tobytes())
        count += rows
    header = struct.pack(">IIBBBBB", width, height, depth, color, 0, 0,
                         1 if interlace else 0)
    table = b""
    if palette is not None:
        palette = np.asarray(palette, np.uint8)
        table = _chunk(b"PLTE", palette[:, :3].tobytes())
        if palette.shape[1] == 4:
            table += _chunk(b"tRNS", palette[:, 3].tobytes())
    return (SIGNATURE + _chunk(b"IHDR", header) + table
            + _chunk(b"IDAT", zlib.compress(b"".join(scanlines)))
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
    """PNG bytes -> ((width, height, bit depth, color type, interlace
    method), PLTE entries (K, 3) uint8 or None, tRNS bytes or None, the
    inflated scanlines: a filter byte before each row, pass after pass
    when interlaced).  Checks every chunk's CRC and the header; data too
    short for the rows (of any pass) raises."""
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
    if interlace not in (0, 1):
        raise ValueError(f"PNG interlace method {interlace}")
    if color not in _CHANNELS or depth not in (1, 2, 4, 8, 16):
        raise ValueError(f"PNG color type {color}, bit depth {depth}")
    raw = zlib.decompress(b"".join(idat))
    end = 0
    for number, *_, cols, rows in passes(width, height, interlace):
        end += rows * (_stride(cols, depth, color) + 1)
        if len(raw) < end:
            raise ValueError(
                f"interlaced (Adam7) PNG image data is truncated in pass "
                f"{number}" if interlace else "PNG image data is truncated")
    return (width, height, depth, color, interlace), palette, alpha, raw


def _stride(width, depth, color):
    return (width * depth * _CHANNELS[color] + 7) // 8


def _samples(rows, width, depth, channels):
    """Unfiltered (h, stride) scanline bytes -> (h, width, channels)
    samples: uint16 at depth 16, else uint8 (1/2/4-bit values as
    stored)."""
    height = rows.shape[0]
    if depth == 16:
        return rows.view(">u2").reshape(height, width, channels).astype(
            np.uint16)
    if depth < 8:
        rows = np.unpackbits(rows, axis=1).reshape(height, -1, depth)
        rows = (rows * (1 << np.arange(depth - 1, -1, -1))).sum(-1)
        rows = rows[:, :width].astype(np.uint8)
    return rows.reshape(height, width, channels)


def decode(data):
    """PNG bytes -> (H, W, C) samples: uint8 for bit depths up to 8 (1/2/4-
    bit gray scaled to 0-255, palette indices expanded to RGB, or RGBA
    when the palette has transparency), uint16 for 16-bit files; C is 1
    gray, 2 gray + alpha, 3 RGB, 4 RGBA.  An interlaced file's passes are
    unfiltered one by one and scattered into the image."""
    (width, height, depth, color, interlace), palette, alpha, raw = \
        inflate(data)
    channels = _CHANNELS[color]
    bpp = max(1, depth * channels // 8)
    pixels = np.zeros((height, width, channels),
                      np.uint16 if depth == 16 else np.uint8)
    start, raw = 0, memoryview(raw)
    for _, y0, x0, dy, dx, cols, rows in passes(width, height, interlace):
        stride = _stride(cols, depth, color)
        part = _unfilter(raw[start:], rows, stride, bpp)
        pixels[y0::dy, x0::dx] = _samples(part, cols, depth, channels)
        start += rows * (stride + 1)
    if color == 0 and depth < 8:
        pixels *= np.uint8(255 // ((1 << depth) - 1))
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
