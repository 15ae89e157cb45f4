"""Edge/planar feature selection, fixed budget per (ring, sector)
(port of ``velo_tpu/lidar/features.py``).

Query features must be strict local curvature extrema within +/-h (the
parallel form of LOAM's greedy spacing); targets use looser gates and
larger budgets.  Each (ring, sector) block keeps its top-k by k passes of
max/argmax, which keeps the reference's first-index-on-ties order
(``torch.topk`` does not promise an order among ties).  The picks are a
gather; the reference's one-hot contraction was a TPU workaround.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from benchmarks.reference.lidar.curvature import CurvatureResult
from benchmarks.reference.lidar.rangeimage import RangeImage

_NEG = -1e30


class ScanFeatures(NamedTuple):
    edges: torch.Tensor  # (K_edge, 3)
    edge_mask: torch.Tensor  # (K_edge,)
    planars: torch.Tensor  # (K_planar, 3)
    planar_mask: torch.Tensor  # (K_planar,)
    edge_phase: torch.Tensor  # (K_edge,) sweep phase of each feature
    planar_phase: torch.Tensor  # (K_planar,)
    edge_ring: torch.Tensor  # (K_edge,) int32 laser ring of each feature
    planar_ring: torch.Tensor  # (K_planar,)


def _local_extremum(curv: torch.Tensor, h: int, mode: str) -> torch.Tensor:
    """Strict local max (or min) of curvature along azimuth within +/-h."""
    is_ext = torch.ones(curv.shape, dtype=torch.bool, device=curv.device)
    for j in range(1, h + 1):
        for s in (j, -j):
            nb = torch.roll(curv, s, dims=1)
            is_ext = is_ext & ((curv >= nb) if mode == "max" else (curv <= nb))
    return is_ext


def _extract_topk(s: torch.Tensor, k: int):
    """Descending top-k along the last axis, first index on ties."""
    iota = torch.arange(s.shape[-1], device=s.device)
    vals, idxs = [], []
    for _ in range(k):
        i = torch.argmax(s, dim=-1)
        vals.append(torch.amax(s, dim=-1))
        idxs.append(i)
        s = torch.where(iota == i[..., None], _NEG, s)
    return torch.stack(vals, dim=-1), torch.stack(idxs, dim=-1)


def _sector_topk(score: torch.Tensor, ok: torch.Tensor, xyz: torch.Tensor,
                 phase: torch.Tensor, n_sectors: int, k: int):
    """Masked top-k per (ring, sector) -> picked points + masks, flattened."""
    R, W = score.shape
    ws = W // n_sectors
    s = torch.where(ok, score, _NEG).reshape(R, n_sectors, ws)
    vals, idx = _extract_topk(s, k)  # (R, S, k) indices within sector
    picked_ok = vals > _NEG / 2
    chan = torch.cat([xyz, phase[..., None]], dim=-1).reshape(
        R, n_sectors, ws, 4)
    picked = torch.gather(chan, 2, idx[..., None].expand(R, n_sectors, k, 4))
    pts = picked[..., :3].reshape(-1, 3)
    ph = picked[..., 3].reshape(-1)
    row = torch.arange(R, dtype=torch.int32, device=score.device)
    row = row[:, None, None].expand(idx.shape)
    return pts, picked_ok.reshape(-1), ph, row.reshape(-1)


def select_features(ri: RangeImage, cr: CurvatureResult, cfg,
                    target: bool = False) -> ScanFeatures:
    """Pick edge/planar features: the sparse query set, or with
    ``target=True`` the denser, looser-gated set the next frame matches."""
    h = cfg.curvature_halfwin
    mult = cfg.target_mult if target else 1
    edge_gate = cfg.edge_min_curv * (0.6 if target else 1.0)
    planar_gate = cfg.planar_max_curv * (2.0 if target else 1.0)

    edge_cand = cr.edge_ok & (cr.curv > edge_gate)
    planar_cand = cr.planar_ok & (cr.curv < planar_gate)
    if not target:
        edge_cand = edge_cand & _local_extremum(
            torch.where(cr.scored, cr.curv, _NEG), h, "max")
        planar_cand = planar_cand & _local_extremum(
            torch.where(cr.scored, cr.curv, -_NEG), h, "min")

    edges, edge_mask, edge_phase, edge_ring = _sector_topk(
        cr.curv, edge_cand, ri.xyz, ri.phase, cfg.n_sectors,
        cfg.edges_per_sector * mult)
    planars, planar_mask, planar_phase, planar_ring = _sector_topk(
        -cr.curv, planar_cand, ri.xyz, ri.phase, cfg.n_sectors,
        cfg.planars_per_sector * mult)
    edges = torch.where(edge_mask[:, None], edges, 0.0)
    planars = torch.where(planar_mask[:, None], planars, 0.0)
    return ScanFeatures(
        edges=edges, edge_mask=edge_mask, planars=planars,
        planar_mask=planar_mask, edge_phase=edge_phase,
        planar_phase=planar_phase, edge_ring=edge_ring,
        planar_ring=planar_ring,
    )
