"""8-bit grayscale PNG, read and written with the standard library.

The KITTI left-camera frames (``image_0/XXXXXX.png``) are 8-bit grayscale,
non-interlaced PNG files.  This module reads and writes exactly that
format with ``zlib`` and ``struct``, so the port's image input does not
depend on an image library being installed: the result is the same on
every machine.  Anything else in a file (colour, palette, alpha, 16 bit,
interlace) raises a ``ValueError`` that names the feature.
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


def _unfilter(raw: np.ndarray, height: int, width: int,
              path: str) -> np.ndarray:
    """Undo the per-scanline filters of an 8-bit, one-channel image: ``raw``
    is (H, 1 + W) uint8, filter type first."""
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


def write_gray8(path: str, img: np.ndarray) -> None:
    """uint8 (H, W) -> 8-bit grayscale PNG (filter 0 on every scanline)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 2:
        raise ValueError("write_gray8 takes a uint8 (H, W) array, got "
                         f"{img.dtype} {img.shape}")
    height, width = img.shape
    raw = np.zeros((height, width + 1), np.uint8)
    raw[:, 1:] = img
    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, 0,
                                            0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))
