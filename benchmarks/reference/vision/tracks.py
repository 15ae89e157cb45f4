"""Fixed-capacity feature track table (port of ``velo_tpu/vision/tracks.py``).

A static (K,) table with a validity mask: each frame the KLT result moves
the survivors, failed tracks free their slots, and new grid-bucket corners
are compacted into free slots, skipping buckets that a live track holds.
Every step is a fixed-shape tensor op (cumsum, scatter), so nothing waits
on the device: the reference's ``jnp.nonzero(size=K)`` becomes a cumsum
plus a scatter, and its ``mode="drop"`` sets a masked ``index_put_``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from benchmarks.reference.vision.corners import Corners


class TrackTable(NamedTuple):
    uv: torch.Tensor  # (K, 2) current pixel positions
    active: torch.Tensor  # (K,) live track mask
    age: torch.Tensor  # (K,) int32 frames tracked
    prev_xyz_velo: torch.Tensor  # (K, 3) landmark at previous frame (velo)
    has_depth: torch.Tensor  # (K,) landmark depth valid
    depth_grad: torch.Tensor  # (K,) |dt/duv| of the landmark's association
    # (m/px); read only where has_depth


def empty_tracks(cfg, device=None) -> TrackTable:
    K = cfg.k_tracks

    def z(shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return TrackTable(uv=z((K, 2)), active=z((K,), torch.bool),
                      age=z((K,), torch.int32), prev_xyz_velo=z((K, 3)),
                      has_depth=z((K,), torch.bool), depth_grad=z((K,)))


def _bucket_of(uv: torch.Tensor, cfg) -> torch.Tensor:
    bh = cfg.height // cfg.grid_rows
    bw = cfg.width // cfg.grid_cols
    # float -> int32 truncates toward zero, as the reference's astype.
    by = torch.clamp(uv[..., 1].to(torch.int32) // bh, 0, cfg.grid_rows - 1)
    bx = torch.clamp(uv[..., 0].to(torch.int32) // bw, 0, cfg.grid_cols - 1)
    return (by * cfg.grid_cols + bx).long()


def replenish(table: TrackTable, corners: Corners, cfg) -> TrackTable:
    """Fill free slots with new corners from unoccupied grid buckets."""
    K = cfg.k_tracks
    dev = table.uv.device
    n_buckets = cfg.grid_rows * cfg.grid_cols

    # Buckets already holding a live track are off limits (min-distance).
    occupied = torch.zeros((n_buckets,), dtype=torch.int32, device=dev)
    occupied = occupied.scatter_reduce(0, _bucket_of(table.uv, cfg),
                                       table.active.to(torch.int32), "amax")
    cand_ok = corners.valid & (occupied[_bucket_of(corners.uv, cfg)] == 0)

    # Compact candidates to the front, free slots to the front, zip them.
    free = ~table.active
    cand_rank = torch.cumsum(cand_ok.to(torch.int32), 0) - 1  # (G,)
    free_rank = torch.cumsum(free.to(torch.int32), 0) - 1  # (K,)
    # free_idx[r] = index of the r-th free slot (K past the last one).
    free_idx = torch.full((K + 1,), K, dtype=torch.int64, device=dev)
    dest = torch.where(free, free_rank.long(), K)
    slots = torch.arange(K, device=dev).expand_as(dest)
    free_idx = free_idx.scatter(0, dest, slots)
    free_idx = free_idx[:K]
    n_free = torch.sum(free.to(torch.int32))
    # Candidate i goes to slot free_idx[cand_rank[i]] if both are in range.
    take = cand_ok & (cand_rank < n_free)
    slot = torch.where(take, free_idx[torch.clamp(cand_rank, 0, K - 1)], K)

    def put(x, v):
        out = torch.cat([x, x[:1]])  # row K absorbs the dropped writes
        out[slot] = v
        return out[:K]

    return table._replace(
        uv=put(table.uv, corners.uv),
        active=put(table.active, torch.ones_like(corners.valid)),
        age=put(table.age, torch.zeros_like(slot, dtype=torch.int32)),
        has_depth=put(table.has_depth, torch.zeros_like(corners.valid)))


def after_tracking(table: TrackTable, new_uv: torch.Tensor,
                   ok: torch.Tensor) -> TrackTable:
    """Apply a KLT result: move survivors, deactivate failures."""
    return table._replace(
        uv=torch.where(ok[:, None], new_uv, table.uv),
        active=table.active & ok,
        age=torch.where(ok, table.age + 1, 0),
    )
