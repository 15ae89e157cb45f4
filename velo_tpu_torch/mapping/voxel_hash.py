"""Voxel keys and voxel downsampling
(port of the map-maintenance half of ``velo_tpu/mapping/voxel_hash.py``).

Voxel coordinates pack into one sortable int32 key, 10 bits per axis
around a centre.  The hash-grid kNN engine (``nn_engine="hash"``) is not in
this slice.
"""
from __future__ import annotations

import torch

from velo_tpu_torch import fp

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
