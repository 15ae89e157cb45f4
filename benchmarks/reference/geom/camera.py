"""Pinhole camera / KITTI calibration geometry
(port of ``velo_tpu/geom/camera.py``).

KITTI convention: ``T_cam_velo`` maps Velodyne coordinates into the cam0
frame, and the 3x4 projection matrix ``P`` maps cam0-frame homogeneous
points to pixels.  The reference's full-precision ``heinsum`` becomes
``fp.einsum`` (float64, rounded once), so both devices round alike.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from benchmarks.reference import fp


class Camera(NamedTuple):
    """Calibration bundle: tensors on the pipeline's device."""

    P: torch.Tensor  # (3, 4) pixel projection from the reference cam frame
    T_cam_velo: torch.Tensor  # (4, 4) velodyne -> camera rigid transform
    width: int
    height: int

    @property
    def fx(self):
        return self.P[0, 0]

    @property
    def fy(self):
        return self.P[1, 1]

    @property
    def cx(self):
        return self.P[0, 2]

    @property
    def cy(self):
        return self.P[1, 2]

    def to(self, device) -> "Camera":
        return self._replace(P=self.P.to(device),
                             T_cam_velo=self.T_cam_velo.to(device))


def from_numpy(P, T_cam_velo, width: int, height: int,
               device=None) -> Camera:
    """A :class:`Camera` from numpy calibration (e.g. a fixture's ``P`` and
    ``T_cam_velo``), as float32 tensors on ``device``."""
    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    return Camera(P=t(P), T_cam_velo=t(T_cam_velo), width=int(width),
                  height=int(height))


def _homog(pts: torch.Tensor) -> torch.Tensor:
    return torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)


def project(P: torch.Tensor, pts_cam: torch.Tensor, eps: float = 1e-6):
    """Project camera-frame points with a 3x4 matrix -> (uv (...,2), valid:
    in front of the camera).  NaN-free for masked/padded points."""
    x = fp.einsum("ij,...j->...i", P, _homog(pts_cam))
    z = x[..., 2]
    valid = z > eps
    safe_z = torch.where(valid, z, 1.0)
    return x[..., :2] / safe_z[..., None], valid


def project_depth(P: torch.Tensor, pts_cam: torch.Tensor, eps: float = 1e-6):
    """Like :func:`project` but also returns the projective depth z."""
    uv, valid = project(P, pts_cam, eps)
    z = fp.einsum("j,...j->...", P[2], _homog(pts_cam))
    return uv, z, valid


def backproject(cam: Camera, uv: torch.Tensor,
                depth: torch.Tensor) -> torch.Tensor:
    """Pixel + projective depth -> camera-frame point (with the KITTI
    baseline term P[0,3]: X = ((u - cx) Z - P03) / fx)."""
    z = depth
    x = ((uv[..., 0] - cam.cx) * z - cam.P[0, 3]) / cam.fx
    y = ((uv[..., 1] - cam.cy) * z - cam.P[1, 3]) / cam.fy
    return torch.stack([x, y, z], dim=-1)


def normalized_ray(cam: Camera, uv: torch.Tensor) -> torch.Tensor:
    """Unit-depth viewing ray (X/Z, Y/Z, 1) of a pixel (ignoring baseline)."""
    x = (uv[..., 0] - cam.cx) / cam.fx
    y = (uv[..., 1] - cam.cy) / cam.fy
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


def in_image(cam: Camera, uv: torch.Tensor,
             margin: float = 0.0) -> torch.Tensor:
    return ((uv[..., 0] >= margin) & (uv[..., 0] <= cam.width - 1 - margin)
            & (uv[..., 1] >= margin) & (uv[..., 1] <= cam.height - 1 - margin))
