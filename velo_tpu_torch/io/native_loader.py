"""ctypes bridge to the native scan loader and PNG unfilter
(port of ``velo_tpu/io/native_loader.py``).

``native/veloio.cpp`` (a copy of the reference's source) reads velodyne
``.bin`` files ahead of the frame loop in a C++ thread pool and pads them
to (n_max, 4), or pre-bins them into the (R, W, 5) range-image grid of
``rangeimage.bin_scan_host``; ``native/png_unfilter.cpp`` undoes PNG
scanline filters for ``io/png.py``.  Both are compiled on first use with

    g++ -O3 -std=c++17 -fPIC -pthread -shared

into ``velo_tpu_torch/_build/libveloio-<sha>.so``, where ``<sha>`` is a
hash of the two sources: an edited source is rebuilt, an unchanged one is
loaded as built.  Without g++ :func:`load_library` raises a
``RuntimeError`` that names it; the command line then falls back to the
Python scan reader.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Iterator, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCES = (_PKG / "native" / "veloio.cpp", _PKG / "native" / "png_unfilter.cpp")
BUILD_DIR = _PKG / "_build"
GXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-pthread", "-shared"]

_lib: ctypes.CDLL | None = None


def library_path() -> Path:
    sha = hashlib.sha256(b"".join(s.read_bytes() for s in SOURCES))
    return BUILD_DIR / f"libveloio-{sha.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        done = subprocess.run(
            ["g++", *GXX_FLAGS, "-o", str(tmp), *map(str, SOURCES)],
            capture_output=True, text=True)
    except FileNotFoundError as err:
        raise RuntimeError("native loader unavailable: g++ not found") \
            from err
    if done.returncode != 0:
        raise RuntimeError(f"native loader unavailable: g++ failed (rc "
                           f"{done.returncode}):\n{done.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees a torn file


def load_library() -> ctypes.CDLL:
    """Load the native library, building it at first use; raises a
    ``RuntimeError`` naming g++ when it cannot be built."""
    global _lib
    if _lib is not None:
        return _lib
    path = library_path()
    if not path.exists():
        _build(path)
    lib = ctypes.CDLL(str(path))
    lib.velo_loader_open.restype = ctypes.c_void_p
    lib.velo_loader_open.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int]
    lib.velo_loader_count.restype = ctypes.c_int
    lib.velo_loader_count.argtypes = [ctypes.c_void_p]
    lib.velo_loader_next.restype = ctypes.c_int
    lib.velo_loader_next.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.velo_loader_close.restype = None
    lib.velo_loader_close.argtypes = [ctypes.c_void_p]
    lib.velo_loader_open_binned.restype = ctypes.c_void_p
    lib.velo_loader_open_binned.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.velo_loader_next_binned.restype = ctypes.c_int
    lib.velo_loader_next_binned.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.velo_png_unfilter.restype = ctypes.c_int
    lib.velo_png_unfilter.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    _lib = lib
    return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


class NativeScanLoader:
    """Async prefetching iterator over a directory of velodyne .bin files:
    (n_max, 4) float32 scans padded with the 1e6 sentinel, and their
    (n_max,) validity masks, in file-name order."""

    def __init__(self, velo_dir: str, n_max: int, queue_depth: int = 4,
                 n_threads: int = 2):
        self._h = None
        self._lib = load_library()
        self._h = self._lib.velo_loader_open(
            velo_dir.encode(), n_max, queue_depth, n_threads)
        if not self._h:
            raise FileNotFoundError(f"no .bin scans under {velo_dir}")
        self.n_max = n_max
        self.n_frames = self._lib.velo_loader_count(self._h)

    def __len__(self) -> int:
        return self.n_frames

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        for _ in range(self.n_frames):
            pts = np.empty((self.n_max, 4), np.float32)
            mask = np.empty((self.n_max,), np.uint8)
            n = self._lib.velo_loader_next(self._h, _ptr(pts, ctypes.c_float),
                                           _ptr(mask, ctypes.c_uint8))
            if n == -2:
                return
            if n < 0:
                raise IOError("native loader: scan read failed")
            yield pts, mask.astype(bool)

    def close(self):
        if self._h:
            self._lib.velo_loader_close(self._h)
            self._h = None

    def __del__(self):
        self.close()


class NativeBinnedScanLoader(NativeScanLoader):
    """Async prefetch with in-worker pre-binning into (R, W, 5) grids and
    (R, W) validity masks.

    The C++ workers replicate ``rangeimage.bin_scan_host`` (the same
    winner rule), so frames arrive in the layout of ``prebin_host=True``.
    """

    def __init__(self, velo_dir: str, lidar_cfg, n_max: int = 262144,
                 queue_depth: int = 4, n_threads: int = 4):
        from velo_tpu_torch.lidar import rangeimage as ri_mod

        self._h = None
        self._lib = load_library()
        R, W = lidar_cfg.n_rings, lidar_cfg.n_azimuth
        hdl = 1 if lidar_cfg.ring_mode == "hdl64e" else 0
        beams = np.ascontiguousarray(ri_mod.hdl64e_beam_elevations(R),
                                     dtype=np.float32)
        self._h = self._lib.velo_loader_open_binned(
            velo_dir.encode(), n_max, queue_depth, n_threads, R, W, hdl,
            float(lidar_cfg.az_start), float(lidar_cfg.min_range),
            float(lidar_cfg.max_range), float(lidar_cfg.elev_max_deg),
            float(lidar_cfg.elev_min_deg), _ptr(beams, ctypes.c_float))
        if not self._h:
            raise FileNotFoundError(f"no .bin scans under {velo_dir}")
        self.shape = (R, W)
        self.n_frames = self._lib.velo_loader_count(self._h)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        R, W = self.shape
        for _ in range(self.n_frames):
            grid = np.empty((R, W, 5), np.float32)
            valid = np.empty((R, W), np.uint8)
            n = self._lib.velo_loader_next_binned(
                self._h, _ptr(grid, ctypes.c_float),
                _ptr(valid, ctypes.c_uint8))
            if n == -2:
                return
            if n < 0:
                raise IOError("native loader: scan read failed")
            yield grid, valid.astype(bool)
