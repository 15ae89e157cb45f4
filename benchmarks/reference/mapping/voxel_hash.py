"""Voxel-hash neighbour grid and voxel downsampling
(port of ``velo_tpu/mapping/voxel_hash.py``).

Voxel coordinates pack into one sortable int32 key, 10 bits per axis
around a centre.  The grid (``nn_engine="hash"``) sorts points by key; a
query enumerates its 27-voxel neighbourhood, finds each neighbour key
with one batched binary search, gathers up to ``occupancy`` consecutive
occupants per voxel and keeps the k nearest of those candidates.  Exact
for neighbours within one voxel of the query (``voxel_size >=
max_dist``); keys clamp to a +/-511-cell window around the centre, so
grids are built in a local frame.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from benchmarks.reference import fp

_B = 10  # bits per axis
_HALF = 1 << (_B - 1)  # 512
_SENTINEL = 2**31 - 1


def _pack(coords: torch.Tensor) -> torch.Tensor:
    """Pack (…, 3) int voxel coords into one sortable int32 key."""
    c = torch.clamp(coords + _HALF, 0, (1 << _B) - 1).to(torch.int32)
    return (c[..., 0] << (2 * _B)) | (c[..., 1] << _B) | c[..., 2]


def _voxel_coords(pts: torch.Tensor, voxel_size: float,
                  center: torch.Tensor) -> torch.Tensor:
    return torch.floor(fp.div(pts - center, voxel_size)).to(torch.int32)


class VoxelGrid(NamedTuple):
    keys: torch.Tensor  # (N,) sorted packed voxel keys (sentinel = invalid)
    pts: torch.Tensor  # (N, 3) points in key-sorted order
    payload: torch.Tensor  # (N, P) extra per-point data, sorted
    voxel_size: float
    center: torch.Tensor  # (3,) recentring applied before quantization


def build_grid(pts: torch.Tensor, mask: torch.Tensor, voxel_size: float,
               center: torch.Tensor | None = None,
               payload: torch.Tensor | None = None) -> VoxelGrid:
    """Sort (N, 3) points + mask into a queryable voxel grid.  The stable
    sort keeps equal keys in index order, as ``jnp.argsort`` does."""
    if center is None:
        center = torch.zeros(3, dtype=pts.dtype, device=pts.device)
    if payload is None:
        payload = torch.zeros((pts.shape[0], 0), dtype=torch.int32,
                              device=pts.device)
    keys = torch.where(mask, _pack(_voxel_coords(pts, voxel_size, center)),
                       _SENTINEL)
    order = torch.argsort(keys, stable=True)
    return VoxelGrid(keys=keys[order], pts=pts[order],
                     payload=payload[order], voxel_size=voxel_size,
                     center=center)


def _offsets(device) -> torch.Tensor:
    """(27, 3) int32 voxel offsets, dx slowest and dz fastest, each in
    (-1, 0, 1): made on the device from an arange (it captures)."""
    a = torch.arange(27, dtype=torch.int32, device=device)
    return torch.stack([a // 9 - 1, a // 3 % 3 - 1, a % 3 - 1], dim=-1)


def knn(grid: VoxelGrid, queries: torch.Tensor, qmask: torch.Tensor, k: int,
        max_dist: float, occupancy: int = 8):
    """Masked k nearest neighbours within ``max_dist`` via the 27-voxel
    gather.  Returns (idx (Q, k) into ``grid.pts`` order, dist (Q, k),
    valid (Q, k)); masked queries come out all-invalid.

    All 27 x Q neighbour keys go through one binary search and one gather
    of 27 x ``occupancy`` candidates per query.  The k nearest are the
    first k of a stable ascending sort on d²: at equal d² the lower
    candidate slot first, and the invalid slots (d² = inf) in slot order,
    which is ``lax.top_k``'s rule in the reference.
    """
    n = grid.keys.shape[0]
    q = queries.shape[0]
    dev = queries.device
    base = _voxel_coords(queries, grid.voxel_size, grid.center)  # (Q, 3)
    offs = _offsets(dev)  # (27, 3)
    nk = _pack(base[:, None, :] + offs[None, :, :])  # (Q, 27)
    starts = torch.searchsorted(grid.keys, nk.reshape(-1).contiguous(),
                                side="left")
    cand = starts.reshape(q, 27, 1) + torch.arange(occupancy, device=dev)
    cand_idx = torch.clamp(cand, 0, n - 1).reshape(q, 27 * occupancy)
    cand_ok = grid.keys[cand_idx] == torch.repeat_interleave(
        nk, occupancy, dim=1)
    diff = grid.pts[cand_idx] - queries[:, None, :]  # (Q, 27*S, 3)
    d2 = fp.dot3(diff, diff)
    d2 = torch.where(cand_ok & qmask[:, None], d2, torch.inf)
    dist2, top = torch.sort(d2, dim=1, stable=True)
    dist2, top = dist2[:, :k], top[:, :k]
    idx = torch.gather(cand_idx, 1, top)
    valid = torch.isfinite(dist2) & (dist2 <= max_dist * max_dist)
    dist = fp.sqrt(torch.where(torch.isfinite(dist2), dist2, 1e12))
    return idx, dist, valid


def voxel_downsample(pts: torch.Tensor, mask: torch.Tensor,
                     voxel_size: float, center: torch.Tensor | None = None):
    """Keep one representative point per voxel: the lowest index.

    Output is the same length with a reduced validity mask.  The stable sort
    is what makes the survivor the lowest index, as ``jnp.argsort`` (stable)
    does in the reference.
    """
    if center is None:
        center = torch.zeros(3, dtype=pts.dtype, device=pts.device)
    keys = torch.where(mask, _pack(_voxel_coords(pts, voxel_size, center)),
                       _SENTINEL)
    order = torch.argsort(keys, stable=True)
    sk = keys[order]
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=pts.device),
                       sk[1:] != sk[:-1]])
    keep_sorted = first & (sk != _SENTINEL)
    keep = torch.zeros_like(keys, dtype=torch.bool).scatter(0, order,
                                                            keep_sorted)
    return mask & keep
