"""Fixed-capacity local feature map: a ring buffer of world-frame points
(port of ``velo_tpu/mapping/local_map.py``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from velo_tpu_torch import fp
from velo_tpu_torch.mapping import voxel_hash


class LocalMap(NamedTuple):
    pts: torch.Tensor  # (C, 3) world-frame feature points
    mask: torch.Tensor  # (C,) validity
    cursor: torch.Tensor  # scalar int32 ring-buffer write head


def empty_map(capacity: int, device=None) -> LocalMap:
    return LocalMap(
        pts=torch.zeros((capacity, 3), dtype=torch.float32, device=device),
        mask=torch.zeros((capacity,), dtype=torch.bool, device=device),
        cursor=torch.zeros((), dtype=torch.int32, device=device),
    )


def insert(m: LocalMap, new_pts: torch.Tensor,
           new_mask: torch.Tensor) -> LocalMap:
    """Write valid new points over the oldest ring-buffer slots.

    The reference scatters with ``mode="drop"`` and sends invalid lanes out
    of bounds.  Here invalid lanes are routed to one spare row past the end
    of a copy of the buffer, which is then cut off: the write stays a single
    fixed-shape scatter with no host synchronisation.

    With more valid points than slots, the reference's scatter writes in
    lane order, so the last C valid points stay.  A scatter with repeated
    indices leaves the winner unspecified (on the CPU and on the card), so
    the valid lanes before the last C go to the spare row as well: no two
    lanes ever write one slot.
    """
    C = m.pts.shape[0]
    offs = torch.cumsum(new_mask.to(torch.int32), dim=0, dtype=torch.int32) - 1
    n_new = torch.sum(new_mask, dtype=torch.int32)
    pos = torch.where(new_mask & (offs >= n_new - C), (m.cursor + offs) % C,
                      C).long()
    pts = torch.cat([m.pts, m.pts.new_zeros((1, 3))])
    pts[pos] = new_pts
    # index_fill: a Python True assigned by index is a host tensor copied
    # to the card, which a CUDA-graph capture refuses.
    mask = torch.cat([m.mask, m.mask.new_zeros((1,))]).index_fill(0, pos,
                                                                  True)
    cursor = (m.cursor + n_new) % C
    return LocalMap(pts=pts[:C], mask=mask[:C], cursor=cursor)


def maintain(m: LocalMap, center: torch.Tensor, cfg_voxel: float,
             crop_radius: float) -> LocalMap:
    """Voxel dedup + distance crop (both pure mask updates)."""
    d = fp.norm3(m.pts - center[None, :])
    mask = m.mask & (d < crop_radius)
    mask = voxel_hash.voxel_downsample(m.pts, mask, cfg_voxel, center=center)
    return LocalMap(pts=m.pts, mask=mask, cursor=m.cursor)


def to_grid(m: LocalMap, center: torch.Tensor,
            voxel_size: float) -> voxel_hash.VoxelGrid:
    """A queryable voxel grid of the map's points, centred at ``center``."""
    return voxel_hash.build_grid(m.pts, m.mask, voxel_size, center=center)
