"""LiDAR depth -> pixel association (port of
``velo_tpu/vision/depth_assoc.py``).

A pixel bucket grid stands in for a KD-tree:

  build:  project the LiDAR points; scatter-min a packed (depth, index)
          int32 key into an (H/c x W/c) cell grid, so each cell keeps its
          nearest-in-depth point, deterministically;
  query:  gather the 3x3 cell neighbourhood of each feature, take the 3
          winners nearest in pixel distance, fit the plane through their
          3D points and intersect the feature's viewing ray with it.

Gates as in the reference: 3 valid neighbours within the pixel bound,
depth spread, coplanarity of the neighbourhood (occlusion edges),
incidence, depth range, depth sensitivity and the 3-NN depth span.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from benchmarks.reference import fp
from benchmarks.reference.geom import camera as cam_mod
from benchmarks.reference.geom import se3

_IDX_BITS = 17
_DEPTH_Q = 256.0  # ~4 mm quantization
_DEPTH_MAX_Q = (1 << 14) - 1
_SENTINEL = 2**31 - 1


class DepthGrid(NamedTuple):
    xyz: torch.Tensor  # (Cells, 3) winning point per cell, camera frame
    uv: torch.Tensor  # (Cells, 2) its projected pixel position
    valid: torch.Tensor  # (Cells,)
    rows: int
    cols: int


def build_depth_grid(pts_velo: torch.Tensor, mask: torch.Tensor,
                     cam: cam_mod.Camera, cfg) -> DepthGrid:
    """Project the (deskewed) cloud and keep the nearest point per cell."""
    c = cfg.depth_grid_cell
    rows, cols = cfg.height // c, cfg.width // c
    n = pts_velo.shape[0]
    dev = pts_velo.device

    p_cam = se3.apply(cam.T_cam_velo, pts_velo)
    uv, z, front = cam_mod.project_depth(cam.P, p_cam)
    ok = (mask & front & (uv[:, 0] >= 0) & (uv[:, 0] < cfg.width)
          & (uv[:, 1] >= 0) & (uv[:, 1] < cfg.height))
    # float -> int truncates toward zero, as the reference's astype; the
    # clamp keeps far-off (masked) projections inside int32.
    iu = torch.clamp(uv, -1e6, 1e6).to(torch.int32)
    cell = (torch.clamp(iu[:, 1] // c, 0, rows - 1) * cols
            + torch.clamp(iu[:, 0] // c, 0, cols - 1))
    zq = torch.clamp(torch.round(z * _DEPTH_Q), 0, _DEPTH_MAX_Q).to(
        torch.int32)
    key = (zq << _IDX_BITS) | torch.arange(n, dtype=torch.int32, device=dev)
    key = torch.where(ok, key, _SENTINEL)
    cell = torch.where(ok, cell, 0).long()
    table = torch.full((rows * cols,), _SENTINEL, dtype=torch.int32,
                       device=dev)
    table = table.scatter_reduce(0, cell, key, "amin", include_self=True)
    cell_ok = table != _SENTINEL
    win = torch.where(cell_ok, table & ((1 << _IDX_BITS) - 1), 0).long()
    return DepthGrid(
        xyz=torch.where(cell_ok[:, None], p_cam[win], 0.0),
        uv=torch.where(cell_ok[:, None], uv[win], -1e4),
        valid=cell_ok, rows=rows, cols=cols)


def build_depth_grid_from_ri(ri, cam: cam_mod.Camera, cfg,
                             az_start: float = 0.0,
                             half_fov: float = 0.9) -> DepthGrid:
    """Depth grid from the forward-facing slice of the range image: the
    azimuth window of half-width ``half_fov`` (rad) around the camera axis
    (+x), taken as two static column slices (wrapping)."""
    R, W = ri.rng.shape
    phase0 = (az_start % (2 * math.pi)) / (2 * math.pi)
    w_half = max(1, int(round(half_fov / (2 * math.pi) * W)))
    c0 = int(round(phase0 * W))
    xs, vs = [], []
    for start in ((c0 - w_half) % W, c0):
        if start + w_half <= W:
            xs.append(ri.xyz[:, start:start + w_half])
            vs.append(ri.valid[:, start:start + w_half])
        else:  # wraps: split
            a = W - start
            xs.append(torch.cat([ri.xyz[:, start:], ri.xyz[:, :w_half - a]],
                                dim=1))
            vs.append(torch.cat([ri.valid[:, start:],
                                 ri.valid[:, :w_half - a]], dim=1))
    pts = torch.cat(xs, dim=1).reshape(-1, 3)
    mask = torch.cat(vs, dim=1).reshape(-1)
    return build_depth_grid(pts, mask, cam, cfg)


class DepthResult(NamedTuple):
    xyz_cam: torch.Tensor  # (K, 3) feature landmark in the camera frame
    depth: torch.Tensor  # (K,) projective depth
    ok: torch.Tensor  # (K,)
    grad: torch.Tensor  # (K,) |dt/duv| depth sensitivity (m/px; 0 where !ok)


def associate(grid: DepthGrid, feat_uv: torch.Tensor,
              feat_mask: torch.Tensor, cam: cam_mod.Camera,
              cfg) -> DepthResult:
    """Interpolate LiDAR depth at tracked feature pixels (plane through
    the 3 nearest cell winners)."""
    c = cfg.depth_grid_cell
    rows, cols = grid.rows, grid.cols
    iu = torch.clamp(feat_uv, -1e6, 1e6).to(torch.int32)
    fr = torch.clamp(iu[:, 1] // c, 0, rows - 1)
    fc = torch.clamp(iu[:, 0] // c, 0, cols - 1)

    s = cfg.depth_search_cells
    idx = []
    for dy in range(-s, s + 1):
        for dx in range(-s, s + 1):
            r = torch.clamp(fr + dy, 0, rows - 1)
            cc = torch.clamp(fc + dx, 0, cols - 1)
            idx.append(r * cols + cc)
    idx = torch.stack(idx, dim=1).long()  # (K, (2s+1)^2)
    uv9, xyz9, ok9 = grid.uv[idx], grid.xyz[idx], grid.valid[idx]

    du = uv9 - feat_uv[:, None, :]
    d2 = du[..., 0] * du[..., 0] + du[..., 1] * du[..., 1]
    max_px = (s + 1.0) * c
    d2 = torch.where(ok9, d2, torch.inf)
    # Stable descending sort of -d2 keeps lax.top_k's lower-index-first
    # order among ties.
    neg, top = torch.sort(-d2, dim=1, descending=True, stable=True)
    neg, top = neg[:, :3], top[:, :3]
    near_ok = torch.isfinite(-neg) & (-neg <= max_px * max_px)
    p3 = torch.gather(xyz9, 1, top[..., None].expand(-1, -1, 3))  # (K,3,3)

    # Depth-spread gate: do not interpolate across a discontinuity.
    z3 = p3[..., 2]
    z_hi = torch.amax(z3, dim=1)
    z_lo = torch.amin(z3, dim=1)
    ok = feat_mask & torch.all(near_ok, dim=1) & (z_hi - z_lo
                                                  < cfg.max_depth_spread)

    # Plane through the 3 points; intersect the viewing ray.
    n = fp.cross3(p3[:, 1] - p3[:, 0], p3[:, 2] - p3[:, 0])
    nn = fp.norm3(n)
    ok = ok & (nn > 1e-6)
    n_hat = n / torch.clamp(nn, min=1e-6)[:, None]

    # Occlusion-edge gate: every valid pixel-near candidate must be
    # coplanar with the 3-NN plane.
    plane_d = torch.abs(fp.dot3(n_hat[:, None, :], xyz9 - p3[:, :1]))
    near_px = ok9 & (d2 <= max_px * max_px)
    outlier = torch.any(near_px & (plane_d > cfg.max_plane_outlier), dim=1)
    ok = ok & ~outlier
    ray = cam_mod.normalized_ray(cam, feat_uv)  # depth-1 ray
    denom = fp.dot3(n_hat, ray)
    ok = ok & (torch.abs(denom) > 1e-4)
    # Grazing-incidence gate.
    cos_inc = torch.abs(denom) / torch.clamp(fp.norm3(ray), min=1e-6)
    ok = ok & (cos_inc > cfg.min_plane_incidence)
    t = fp.dot3(n_hat, p3[:, 0]) / torch.where(torch.abs(denom) > 1e-4,
                                               denom, 1.0)
    ok = ok & (t > 0.5) & (t < 120.0)
    # Depth-sensitivity gate: metres of depth per pixel of track error.
    gu = t * n_hat[:, 0] / (cam.fx * denom)
    gv = t * n_hat[:, 1] / (cam.fy * denom)
    grad2 = gu * gu + gv * gv
    ok = ok & (grad2 < cfg.max_depth_grad ** 2)
    # The intersection must land within the 3-NN depth span (+slack); the
    # ray has z = 1, so t is the projective depth.
    ok = ok & (t >= z_lo - cfg.depth_range_slack)
    ok = ok & (t <= z_hi + cfg.depth_range_slack)
    xyz = ray * t[:, None]
    return DepthResult(
        xyz_cam=torch.where(ok[:, None], xyz, 0.0),
        depth=torch.where(ok, t, 0.0),
        ok=ok,
        grad=torch.where(ok, fp.sqrt(grad2), 0.0),
    )
