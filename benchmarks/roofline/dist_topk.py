"""Work of the ``dist_topk`` kernel per odometry frame, counted from its
shapes (frozen from ``chip_smoke.py``'s bound).

Each call ranks Q queries against N targets and keeps k candidates: per
query-target pair 4 products and 3 sums of the score (7 float32
operations); bytes are each input read once and each output written once:
targets and mask (13 bytes per target), queries (12 per query), distances
and indices (8 per kept candidate).

A frame of the dense engine searches four target sets
(``solve/icp.build_candidates`` -> ``mapping/dense_nn.knn``): the previous
scan's edge and planar features (``k_* x target_mult`` targets) and the
edge and planar maps (their capacities), with the current scan's
``k_edge`` / ``k_planar`` features as queries and 16 candidates each.
"""
from __future__ import annotations

from benchmarks import roofline

OPS_PER_PAIR = 7
CANDIDATES = 16


def frame_calls(cfg) -> list[tuple[int, int]]:
    """(Q, N) of each search a frame needs: scan-to-scan edges and
    planars, scan-to-map edges and planars; [] off the dense engine."""
    if cfg.solver.nn_engine != "dense" or cfg.solver.nn_approx_impl != "pallas":
        return []
    lc = cfg.lidar
    calls = [(lc.k_edge, lc.k_edge * lc.target_mult),
             (lc.k_planar, lc.k_planar * lc.target_mult)]
    if cfg.use_map:
        calls += [(lc.k_edge, cfg.map.edge_capacity),
                  (lc.k_planar, cfg.map.planar_capacity)]
    return calls


def call_work(q: int, n: int, k: int = CANDIDATES) -> tuple[float, float]:
    """(bytes, float32 operations) one call needs."""
    return n * 13 + q * 12 + q * k * 8, q * n * OPS_PER_PAIR


def frame_least_seconds(cfg) -> float:
    """The least time the kernel's work of one frame takes on the card."""
    return sum(roofline.least_seconds(*call_work(q, n))
               for q, n in frame_calls(cfg))
