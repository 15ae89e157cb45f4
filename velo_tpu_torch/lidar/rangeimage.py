"""Ring-organized range image (port of ``velo_tpu/lidar/rangeimage.py``).

Two ways into the fixed (R, W) grid: ``build_range_image`` scatters a
padded raw scan on the device (ring from the elevation angle, column from
the sweep phase, the nearest return wins a cell through one scatter-min
over packed ``(quantized_range << 17) | point_index`` keys, which is
independent of the order of the updates and so deterministic), and
``range_image_from_grid`` deskews a grid that ``bin_scan_host`` filled on
the host.  ``bin_scan_host`` is numpy code; the reference's copy cannot be
shared because its module imports ``jax.numpy``, so it is repeated here
line for line (as ``_bin_scan_host``) and the tests hold the two bitwise
equal.
"""
from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from velo_tpu_torch import fp
from velo_tpu_torch.evaluation import profiling
from velo_tpu_torch.lidar import deskew as deskew_mod

_IDX_BITS = 17  # supports up to 131072 raw points
_RANGE_Q = 100.0  # 1 cm quantization for the winner key
_RANGE_MAX_Q = (1 << 14) - 1  # 14 bits => 163 m at 1 cm


@lru_cache(maxsize=4)
def hdl64e_beam_elevations(n_rings: int = 64) -> np.ndarray:
    """Nominal HDL-64E beam elevations (rad), descending (ring 0 = top)."""
    upper = np.linspace(2.0, -8.33, 32)
    lower = np.linspace(-8.83, -24.33, 32)
    table = np.concatenate([upper, lower])
    if n_rings != 64:
        table = np.interp(np.linspace(0, 63, n_rings), np.arange(64), table)
    return np.deg2rad(table)


class RangeImage(NamedTuple):
    xyz: torch.Tensor  # (R, W, 3) deskewed points
    rng: torch.Tensor  # (R, W) range (0 where invalid)
    phase: torch.Tensor  # (R, W) sweep phase of the stored point
    valid: torch.Tensor  # (R, W) bool


def _deg2rad32(deg: float) -> float:
    """``jnp.deg2rad`` of a Python number: a float32 product."""
    return float(np.float32(deg) * np.float32(np.pi / 180.0))


def build_range_image(pts: torch.Tensor, mask: torch.Tensor,
                      phase: torch.Tensor, cfg) -> RangeImage:
    """Scatter (N, 3) points + validity into the fixed (R, W) ring grid.

    ``pts`` must already be deskewed; ``phase`` is the per-point sweep
    phase of ``deskew.azimuth_phase`` (reused as the column coordinate, so
    the grid follows acquisition order even after deskew moved the
    Cartesian azimuth slightly).
    """
    R, W = cfg.n_rings, cfg.n_azimuth
    n = pts.shape[0]
    dev = pts.device
    if n > (1 << _IDX_BITS):
        raise ValueError(f"{n} points: raise _IDX_BITS for larger scans")

    rng = fp.norm3(pts)
    ok = mask & (rng >= cfg.min_range) & (rng <= cfg.max_range)
    safe_rng = torch.where(ok, rng, 1.0)
    elev = fp.arcsin(torch.clamp(pts[..., 2] / safe_rng, -1.0, 1.0))
    if cfg.ring_mode == "hdl64e":
        # Nearest beam of the nominal HDL-64E two-block elevation table.
        beams = fp.const(hdl64e_beam_elevations(R), torch.float32, dev)
        d = torch.abs(elev[:, None] - beams[None, :])  # (N, R)
        gap = torch.min(d, dim=1).values
        # The first beam at the least distance (torch.argmin promises no
        # order among ties).
        order = torch.arange(R, dtype=torch.int32, device=dev)
        ring = torch.min(torch.where(d == gap[:, None], order[None, :], R),
                         dim=1).values.to(torch.int32)
        # Reject points falling between beams (noise / other sensors).
        ok = ok & (gap < _deg2rad32(0.6))
    else:
        e_max = torch.full((), _deg2rad32(cfg.elev_max_deg), device=dev)
        e_min = torch.full((), _deg2rad32(cfg.elev_min_deg), device=dev)
        ring_f = (e_max - elev) / (e_max - e_min) * (R - 1)
        ring = torch.clamp(torch.round(ring_f).to(torch.int32), 0, R - 1)
        # Reject points whose elevation is far outside the laser fan.
        ok = ok & (ring_f > -1.0) & (ring_f < R)

    col = torch.clamp((phase * W).to(torch.int32), 0, W - 1)

    # Deterministic nearest-return winner per cell via packed scatter-min
    # (int64 keys: scatter_reduce_ has no int32 "amin" on every build).
    rq = torch.clamp(torch.round(rng * _RANGE_Q), 0, _RANGE_MAX_Q).long()
    key = (rq << _IDX_BITS) | torch.arange(n, dtype=torch.int64, device=dev)
    sentinel = 2**31 - 1
    key = torch.where(ok, key, sentinel)
    # Invalid points all target cell 0 with the sentinel key (harmless).
    flat_cell = torch.where(ok, ring * W + col, 0).long()
    table = torch.full((R * W,), sentinel, dtype=torch.int64, device=dev)
    table = table.scatter_reduce(0, flat_cell, key, "amin",
                                 include_self=True)

    cell_valid = table != sentinel
    win_idx = torch.where(cell_valid, table & ((1 << _IDX_BITS) - 1), 0)
    vals = torch.cat([pts, rng[:, None], phase[:, None]], dim=-1)
    win = torch.where(cell_valid[:, None], vals[win_idx], 0.0)  # (R*W, 5)
    return RangeImage(xyz=win[:, :3].reshape(R, W, 3),
                      rng=win[:, 3].reshape(R, W),
                      phase=win[:, 4].reshape(R, W),
                      valid=cell_valid.reshape(R, W))


def bin_scan_host(scan: np.ndarray, cfg):
    """Host-side pre-binning of a raw scan into the (R, W) grid, in the
    profiler span ``velo.bin_scan_host`` while a profiler is active.

    Returns (grid (R, W, 5) float32 [x, y, z, range, phase] of the nearest
    raw return per cell, valid (R, W) bool).
    """
    with profiling.span("velo.bin_scan_host"):
        return _bin_scan_host(scan, cfg)


def _bin_scan_host(scan: np.ndarray, cfg):
    R, W = cfg.n_rings, cfg.n_azimuth
    pts = np.asarray(scan[:, :3], np.float32)
    n = len(pts)
    rng = np.linalg.norm(pts, axis=-1)
    ok = (rng >= cfg.min_range) & (rng <= cfg.max_range)
    safe = np.where(ok, rng, 1.0)
    elev = np.arcsin(np.clip(pts[:, 2] / safe, -1.0, 1.0))
    if cfg.ring_mode == "hdl64e":
        beams = hdl64e_beam_elevations(R)
        d = np.abs(elev[:, None] - beams[None, :])
        ring = d.argmin(axis=1).astype(np.int64)
        ok = ok & (d.min(axis=1) < np.deg2rad(0.6))
    else:
        e_max = np.deg2rad(cfg.elev_max_deg)
        e_min = np.deg2rad(cfg.elev_min_deg)
        ring_f = (e_max - elev) / (e_max - e_min) * (R - 1)
        ring = np.clip(np.round(ring_f), 0, R - 1).astype(np.int64)
        ok = ok & (ring_f > -1.0) & (ring_f < R)
    az = np.arctan2(pts[:, 1], pts[:, 0])
    phase = np.mod(cfg.az_start - az, 2.0 * np.pi) / (2.0 * np.pi)
    col = np.clip((phase * W).astype(np.int64), 0, W - 1)

    # Deterministic nearest-return winner: min over packed (range, index).
    rq = np.clip(np.round(rng * _RANGE_Q), 0, _RANGE_MAX_Q).astype(np.int64)
    key = (rq << _IDX_BITS) | np.arange(n, dtype=np.int64)
    sentinel = np.int64(1) << 62
    table = np.full(R * W, sentinel, np.int64)
    flat = ring * W + col
    np.minimum.at(table, flat[ok], key[ok])
    valid = table != sentinel
    win_idx = np.where(valid, table & ((1 << _IDX_BITS) - 1), 0)
    vals = np.concatenate(
        [pts, rng[:, None].astype(np.float32),
         phase[:, None].astype(np.float32)], axis=-1)
    grid = np.where(valid[:, None], vals[win_idx], 0.0).astype(np.float32)
    return grid.reshape(R, W, 5), valid.reshape(R, W)


def range_image_from_grid(grid: torch.Tensor, valid: torch.Tensor,
                          delta_xi: torch.Tensor, cfg,
                          enabled: bool = True) -> RangeImage:
    """Deskew a host-pre-binned (R, W, 5) grid into a :class:`RangeImage`."""
    R, W = cfg.n_rings, cfg.n_azimuth
    pts = grid[..., :3].reshape(-1, 3)
    phase = grid[..., 4].reshape(-1)
    if enabled:
        pts = deskew_mod.apply_scaled_exp(pts, phase, delta_xi)
    rng = fp.norm3(pts)
    vflat = valid.reshape(-1)
    pts = torch.where(vflat[:, None], pts, 0.0)
    rng = torch.where(vflat, rng, 0.0)
    return RangeImage(xyz=pts.reshape(R, W, 3), rng=rng.reshape(R, W),
                      phase=torch.where(vflat, phase, 0.0).reshape(R, W),
                      valid=valid)
