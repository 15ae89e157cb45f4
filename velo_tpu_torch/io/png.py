"""8-bit grayscale PNG, read and written with the standard library.

The KITTI left-camera frames (``image_0/XXXXXX.png``) are 8-bit grayscale,
non-interlaced PNG files.  This module reads and writes exactly that
format with ``zlib`` and ``struct``, so the port's image input does not
depend on an image library being installed: the result is the same on
every machine.  Anything else in a file (colour, palette, alpha, 16 bit,
interlace) raises a ``ValueError`` that names the feature.

The scanline filters are undone in C++ (``native/png_unfilter.cpp``,
through ``io.native_loader``), in one ctypes call that releases the GIL,
so ``kitti.ImagePrefetcher``'s threads decode while the frame loop runs;
inflation (``zlib``) releases it too.  Without g++ to build that library,
:func:`read_gray8` raises.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOUR_TYPES = {2: "colour (RGB)", 3: "palette", 4: "grayscale with alpha",
                 6: "colour with alpha (RGBA)"}


def _chunks(data: bytes, path: str):
    """Yield (type, payload) of every chunk, CRCs checked."""
    pos = len(_SIGNATURE)
    while pos < len(data):
        if pos + 8 > len(data):
            raise ValueError(f"{path}: truncated PNG chunk header")
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 8 + length
        if end + 4 > len(data):
            raise ValueError(f"{path}: truncated PNG chunk {ctype!r}")
        payload = data[pos + 8:end]
        (crc,) = struct.unpack(">I", data[end:end + 4])
        if zlib.crc32(ctype + payload) != crc:
            raise ValueError(f"{path}: CRC mismatch in PNG chunk {ctype!r}")
        yield ctype, payload
        pos = end + 4
        if ctype == b"IEND":
            return
    raise ValueError(f"{path}: PNG without an IEND chunk")


def _unfilter_reference(raw: np.ndarray, height: int, width: int,
                        path: str) -> np.ndarray:
    """Undo the per-scanline filters of an 8-bit, one-channel image: ``raw``
    is (H, 1 + W) uint8, filter type first.  The plain Python version of
    :func:`_unfilter`; the tests hold the two equal byte for byte."""
    out = np.zeros((height, width), np.uint8)
    zero = np.zeros(width, np.uint8)
    for y in range(height):
        ftype = int(raw[y, 0])
        line = raw[y, 1:]
        up = out[y - 1] if y else zero
        if ftype == 0:  # None
            out[y] = line
        elif ftype == 2:  # Up
            out[y] = line + up  # uint8 arithmetic wraps mod 256
        elif ftype in (1, 3, 4):
            # Sub, Average and Paeth depend on the pixel to the left, which
            # is itself a result: a sequential pass over the row.
            row = line.astype(np.int64)
            upi = up.astype(np.int64)
            left = upleft = 0
            for x in range(width):
                b = int(upi[x])
                if ftype == 1:
                    pred = left
                elif ftype == 3:
                    pred = (left + b) >> 1
                else:
                    p = left + b - upleft
                    pa, pb, pc = abs(p - left), abs(p - b), abs(p - upleft)
                    pred = (left if pa <= pb and pa <= pc
                            else b if pb <= pc else upleft)
                left = (int(row[x]) + pred) & 255
                row[x] = left
                upleft = b
            out[y] = row.astype(np.uint8)
        else:
            raise ValueError(f"{path}: unknown PNG filter type {ftype}")
    return out


def _unfilter(raw: np.ndarray, height: int, width: int,
              path: str) -> np.ndarray:
    """:func:`_unfilter_reference` in one native call (GIL released)."""
    import ctypes

    from velo_tpu_torch.io import native_loader

    lib = native_loader.load_library()
    raw = np.ascontiguousarray(raw, np.uint8)
    out = np.empty((height, width), np.uint8)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    bad = lib.velo_png_unfilter(raw.ctypes.data_as(u8), height, width,
                                out.ctypes.data_as(u8))
    if bad:
        raise ValueError(f"{path}: unknown PNG filter type "
                         f"{int(raw[bad - 1, 0])}")
    return out


def read_gray8(path: str) -> np.ndarray:
    """8-bit grayscale, non-interlaced PNG -> uint8 (H, W)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:len(_SIGNATURE)] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    header = None
    idat = []
    for ctype, payload in _chunks(data, path):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif ctype == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    width, height, depth, colour, compression, filt, interlace = header
    if colour != 0:
        raise ValueError(
            f"{path}: {_COLOUR_TYPES.get(colour, f'colour type {colour}')} "
            "PNG is not supported, only 8-bit grayscale")
    if depth != 8:
        raise ValueError(f"{path}: {depth}-bit PNG is not supported, only "
                         "8-bit grayscale")
    if interlace != 0:
        raise ValueError(f"{path}: interlaced (Adam7) PNG is not supported")
    if compression != 0 or filt != 0:
        raise ValueError(f"{path}: unknown PNG compression/filter method")
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != height * (width + 1):
        raise ValueError(f"{path}: PNG image data has {len(raw)} bytes, "
                         f"expected {height * (width + 1)}")
    raw = np.frombuffer(raw, np.uint8).reshape(height, width + 1)
    return _unfilter(raw, height, width, path)


def _chunk(ctype: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + ctype + payload
            + struct.pack(">I", zlib.crc32(ctype + payload)))


def _filter_rows(img: np.ndarray, filters) -> np.ndarray:
    """(H, W) uint8 -> (H, 1 + W) scanlines, row y filtered with type
    ``filters[y]`` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    height, width = img.shape
    x = img.astype(np.int64)
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]  # left
    b = np.zeros_like(x)
    b[1:] = x[:-1]  # up
    c = np.zeros_like(x)
    c[1:, 1:] = x[:-1, :-1]  # up-left
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    pred = {0: 0, 1: a, 2: b, 3: (a + b) >> 1, 4: paeth}
    raw = np.zeros((height, width + 1), np.uint8)
    for y, f in enumerate(filters):
        p_y = pred[int(f)]
        raw[y, 0] = f
        raw[y, 1:] = (x[y] - (p_y[y] if f else 0)) & 255
    return raw


def write_gray8(path: str, img: np.ndarray, filters=None) -> None:
    """uint8 (H, W) -> 8-bit grayscale PNG.  ``filters`` gives each
    scanline's filter type (default: 0, None, on every row)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 2:
        raise ValueError("write_gray8 takes a uint8 (H, W) array, got "
                         f"{img.dtype} {img.shape}")
    height, width = img.shape
    raw = _filter_rows(img, np.zeros(height, int) if filters is None
                       else filters)
    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, 0,
                                            0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))
