"""KITTI odometry dataset I/O, host-side, numpy only
(the port's own copy of ``velo_tpu/io/kitti.py``; the tests hold the code
of every function but ``read_image_gray`` equal to the original's).

File formats (immutable KITTI conventions):
  * ``velodyne/XXXXXX.bin``  — float32 little-endian, N x 4 (x, y, z, reflectance)
  * ``image_0/XXXXXX.png``   — 8-bit grayscale, left camera
  * ``calib.txt``            — ``P0: <12 floats>`` … ``P3``, ``Tr: <12 floats>``
  * ``times.txt``            — one float per frame (seconds)
  * ``poses/XX.txt``         — 12 floats per line, row-major 3x4 cam0 pose

Device-facing helpers pad everything to fixed shapes.  Images are decoded
by :mod:`velo_tpu_torch.io.png` (the original uses OpenCV), so the result
does not depend on which image library a machine has.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from velo_tpu_torch.io import png


def read_velodyne_bin(path: str) -> np.ndarray:
    """Raw scan -> float32 (N, 4) array of x, y, z, reflectance."""
    data = np.fromfile(path, dtype=np.float32)
    return data.reshape(-1, 4)


def read_image_gray(path: str) -> np.ndarray:
    """8-bit grayscale PNG -> float32 (H, W) in [0, 1]."""
    return png.read_gray8(path).astype(np.float32) / 255.0


def read_calib(path: str) -> Dict[str, np.ndarray]:
    """Parse KITTI calib.txt -> {'P0'..'P3': (3,4), 'Tr': (4,4)}."""
    out: Dict[str, np.ndarray] = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            key, vals = line.split(":", 1)
            arr = np.array([float(v) for v in vals.split()], dtype=np.float64)
            if arr.size == 12:
                mat = arr.reshape(3, 4)
                if key.strip() == "Tr":
                    mat = np.vstack([mat, [0.0, 0.0, 0.0, 1.0]])
                out[key.strip()] = mat
    return out


def read_times(path: str) -> np.ndarray:
    return np.loadtxt(path, dtype=np.float64).reshape(-1)


def read_poses(path: str) -> np.ndarray:
    """GT/estimated trajectory file -> (F, 4, 4) homogeneous poses."""
    data = np.loadtxt(path, dtype=np.float64).reshape(-1, 3, 4)
    bottom = np.tile(np.array([[[0.0, 0.0, 0.0, 1.0]]]), (data.shape[0], 1, 1))
    return np.concatenate([data, bottom], axis=1)


def write_poses(path: str, poses: np.ndarray) -> None:
    """Write (F, 4, 4) poses as KITTI 12-float row-major 3x4 lines (C14)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = np.asarray(poses)[:, :3, :].reshape(-1, 12)
    with open(path, "w") as f:
        for row in flat:
            f.write(" ".join(f"{v:.9e}" for v in row) + "\n")


def pad_scan(scan: np.ndarray, n_max: int) -> tuple[np.ndarray, np.ndarray]:
    """Pad/truncate a raw (N,4) scan to (n_max,4) + bool validity mask.

    Padded rows are filled with a far sentinel so they can never alias real
    geometry even if a mask is dropped somewhere downstream.
    """
    n = min(scan.shape[0], n_max)
    out = np.full((n_max, 4), 1e6, dtype=np.float32)
    out[:n] = scan[:n]
    mask = np.zeros((n_max,), dtype=bool)
    mask[:n] = True
    return out, mask


class ImagePrefetcher:
    """Threaded read-ahead for per-frame images.

    File reading and ``zlib`` inflation release the GIL, so prefetching
    overlaps them with the device step, which the host only enqueues.
    Sequential access pattern assumed (the streaming odometry loop); a
    random access falls back to a synchronous fetch.
    """

    def __init__(self, fetch, n_frames: int, depth: int = 4,
                 workers: int = 2):
        from concurrent.futures import ThreadPoolExecutor

        self._fetch = fetch
        self._n = n_frames
        self._depth = depth
        self._ex = ThreadPoolExecutor(max_workers=workers)
        self._futs: dict = {}
        for j in range(min(depth, n_frames)):
            self._futs[j] = self._ex.submit(fetch, j)

    def get(self, i: int) -> np.ndarray:
        for j in range(i + 1, min(i + 1 + self._depth, self._n)):
            if j not in self._futs:
                self._futs[j] = self._ex.submit(self._fetch, j)
        fut = self._futs.pop(i, None)
        return fut.result() if fut is not None else self._fetch(i)

    def close(self):
        self._ex.shutdown(wait=False, cancel_futures=True)


class KittiSequence:
    """Lazy per-frame access to one KITTI odometry sequence on disk."""

    def __init__(self, root: str, seq: str, n_max_points: int = 131072):
        self.seq_dir = os.path.join(root, "sequences", seq)
        self.velo_dir = os.path.join(self.seq_dir, "velodyne")
        self.img_dir = os.path.join(self.seq_dir, "image_0")
        self.calib = read_calib(os.path.join(self.seq_dir, "calib.txt"))
        times_path = os.path.join(self.seq_dir, "times.txt")
        self.times = read_times(times_path) if os.path.exists(times_path) else None
        gt_path = os.path.join(root, "poses", f"{seq}.txt")
        self.gt_poses: Optional[np.ndarray] = (
            read_poses(gt_path) if os.path.exists(gt_path) else None
        )
        self.n_max_points = n_max_points
        self.n_frames = len(
            [f for f in os.listdir(self.velo_dir) if f.endswith(".bin")]
        )

    def scan(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        raw = read_velodyne_bin(os.path.join(self.velo_dir, f"{i:06d}.bin"))
        return pad_scan(raw, self.n_max_points)

    def image(self, i: int) -> np.ndarray:
        return read_image_gray(os.path.join(self.img_dir, f"{i:06d}.png"))
