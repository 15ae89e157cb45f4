"""LOAM-style ring curvature + pickability masks
(port of ``velo_tpu/lidar/curvature.py``).

Curvature of point i is the normalized chord deviation over its +/-h ring
neighbors; the masks drop windows with invalid cells, windows that cross
the sweep seam, far-side occlusion runs and near-parallel beams.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from benchmarks.reference import fp
from benchmarks.reference.lidar.rangeimage import RangeImage


class CurvatureResult(NamedTuple):
    curv: torch.Tensor  # (R, W) normalized curvature (0 where unscored)
    scored: torch.Tensor  # (R, W) curvature is meaningful here
    edge_ok: torch.Tensor  # (R, W) allowed to become an edge feature
    planar_ok: torch.Tensor  # (R, W) allowed to become a planar feature


def _roll_w(x: torch.Tensor, shift: int) -> torch.Tensor:
    """Roll along the azimuth axis (wrap-around: the sweep is a closed ring)."""
    return torch.roll(x, shift, dims=1)


def compute_curvature(ri: RangeImage, cfg) -> CurvatureResult:
    h = cfg.curvature_halfwin
    xyz, rng, valid = ri.xyz, ri.rng, ri.valid

    sum_prev = torch.zeros_like(xyz)
    sum_next = torch.zeros_like(xyz)
    all_valid = valid
    for j in range(1, h + 1):
        sum_prev = sum_prev + _roll_w(xyz, j)
        sum_next = sum_next + _roll_w(xyz, -j)
        all_valid = all_valid & _roll_w(valid, j) & _roll_w(valid, -j)
    A = fp.div(sum_prev, h)
    B = fp.div(sum_next, h)
    u = B - A
    chord_sq = fp.dot3(u, u)
    pa = xyz - A
    cross = fp.cross3(pa, u)
    # dist(p, line) / (chord/2) = 2*||pa x u|| / ||u||^2
    curv = 2.0 * fp.norm3(cross) / torch.clamp(
        chord_sq, min=1e-8)

    safe_r = torch.where(rng > 1e-6, rng, 1.0)
    scored = valid & all_valid

    # Sweep-seam exclusion: a window whose phase span exceeds half a sweep
    # straddles the wrap, where raw column order no longer matches space.
    ph = ri.phase
    ph_min, ph_max = ph, ph
    for j in range(1, h + 1):
        ph_min = torch.minimum(torch.minimum(ph_min, _roll_w(ph, j)),
                               _roll_w(ph, -j))
        ph_max = torch.maximum(torch.maximum(ph_max, _roll_w(ph, j)),
                               _roll_w(ph, -j))
    scored = scored & ((ph_max - ph_min) <= 0.5)
    curv = torch.where(scored, curv, 0.0)

    # Occlusion: the h points on the far side of a range jump are
    # view-dependent artifacts and cannot be edges.
    r_next = _roll_w(rng, -1)
    jump_next = torch.abs(r_next - rng) > cfg.occlusion_range_jump * torch.minimum(
        torch.where(rng > 0, rng, 1e6), torch.where(r_next > 0, r_next, 1e6))
    far_is_self = rng > r_next
    occluded = torch.zeros_like(valid)
    far_left = jump_next & far_is_self
    far_right = jump_next & ~far_is_self
    for j in range(h):
        occluded = occluded | _roll_w(far_left, -j)
    for j in range(1, h + 1):
        occluded = occluded | _roll_w(far_right, j)

    # Parallel beam: |dr| > r * dphi * tan(beta_max) on both sides.
    r_prev = _roll_w(rng, 1)
    dphi = 2.0 * math.pi / rng.shape[1]
    lim = cfg.parallel_beam_tan * dphi * safe_r
    near_parallel = (torch.abs(r_next - rng) > lim) & (
        torch.abs(r_prev - rng) > lim)

    edge_ok = scored & ~occluded & ~near_parallel
    planar_ok = scored & ~near_parallel
    return CurvatureResult(curv=curv, scored=scored, edge_ok=edge_ok,
                           planar_ok=planar_ok)
