"""Constant-velocity motion deskew (port of ``velo_tpu/lidar/deskew.py``).

The sweep phase, the matrix-free per-point ``exp(s_i * xi) @ p_i``, the
raw-scan ``deskew`` built from the two, and the re-correction with an
improved motion estimate.
"""
from __future__ import annotations

import math

import torch

from benchmarks.reference import fp

_TWO_PI = 2.0 * math.pi


def azimuth_phase(pts: torch.Tensor, az_start: float = 0.0) -> torch.Tensor:
    """Per-point sweep phase s in [0,1) from the clockwise spin azimuth."""
    az = fp.atan2(pts[..., 1], pts[..., 0])
    return fp.div(torch.remainder(az_start - az, _TWO_PI), _TWO_PI)


def deskew(pts: torch.Tensor, delta_xi: torch.Tensor, az_start: float = 0.0,
           enabled: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Undistort raw (N, 3) points into the sweep-start frame with the
    predicted motion ``delta_xi`` over the full sweep.  Returns (deskewed
    points, per-point phase); ``enabled=False`` keeps the points."""
    s = azimuth_phase(pts, az_start)
    if not enabled:
        return pts, s
    return apply_scaled_exp(pts, s, delta_xi), s


def apply_scaled_exp(pts: torch.Tensor, s: torch.Tensor,
                     xi: torch.Tensor) -> torch.Tensor:
    """``exp(s_i * xi) @ p_i`` for all points, without per-point matrices.

    Every per-point transform shares the rotation axis of ``xi``; only the
    angle scales with the phase, so Rodrigues applies with per-point sin/cos:

        p' = p cos(a) + (k x p) sin(a) + k (k.p)(1 - cos a) + V(a k) (s rho)
    """
    rho, phi = xi[:3], xi[3:]
    theta = fp.norm3(phi)
    small = theta < 1e-8
    k = phi / torch.where(small, 1.0, theta)
    a = s * theta
    sin_a = fp.sin(a)[:, None]
    cos_a = fp.cos(a)[:, None]

    kxp = fp.cross3(k[None, :], pts)
    kdp = fp.dot3(pts, k[None, :])[:, None]
    rot = pts * cos_a + kxp * sin_a + k[None, :] * kdp * (1.0 - cos_a)

    a_col = a[:, None]
    tiny = torch.abs(a_col) < 1e-6
    safe_a = torch.where(tiny, 1.0, a_col)
    B = torch.where(tiny, 0.5 * a_col, (1.0 - cos_a) / safe_a)
    C = torch.where(tiny, fp.div(a_col * a_col, 6.0), (a_col - sin_a) / safe_a)
    kxr = fp.cross3(k, rho)
    kxkxr = fp.cross3(k, kxr)
    t = s[:, None] * (rho[None, :] + B * kxr[None, :] + C * kxkxr[None, :])
    out = rot + t
    return torch.where(small, pts + s[:, None] * rho[None, :], out)


def redeskew(pts: torch.Tensor, phase: torch.Tensor, xi_old: torch.Tensor,
             xi_new: torch.Tensor) -> torch.Tensor:
    """Re-correct deskewed points: p_fix = exp(s*xi_new) exp(-s*xi_old) p."""
    return apply_scaled_exp(apply_scaled_exp(pts, phase, -xi_old), phase,
                            xi_new)
