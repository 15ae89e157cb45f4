"""Work of the voxel-hash correspondence search (``nn_engine="hash"``)
per odometry frame, counted from the shapes the configuration fixes, so
that any implementation of the search (the port's sorts, searches and
gathers today, a hand-written kernel later) is judged on the same work.

The search is bound by memory: its least time is the bytes any
implementation must move at the card's HBM bandwidth.  A grid build
reads its N targets once (point 12 B, mask 1 B, payload 4 B a column)
and writes its sorted grid once (key 4 B, point, payload).  A query
reads its Q queries once (point 12 B, mask 1 B) and its grid once (key,
point, payload), and writes its k results a query once (neighbour point
12 B, payload, distance 4 B, valid 1 B).

A frame builds one grid per target set and solve, and queries each grid
once per outer iteration (``solve/icp._make_engine``): the scan-to-scan
solve (``icp_iters_odom``) and, with deskew off the continuous-time
path, its redeskew re-solve (``icp_iters_redeskew``) against the
previous scan's edge and planar features (``k_* x target_mult`` targets;
the edges carry their ring as a payload column), and each scan-to-map
solve (``icp_iters_map``, averaged over the map's cadence) against the
edge and planar maps (their capacities).  Queries are the current scan's
``k_edge`` / ``k_planar`` features; edges keep 5 neighbours in the
scan-to-scan fit (``_edge_lines_2pt``), everything else ``map_knn``.
"""
from __future__ import annotations

from benchmarks import roofline

POINT, MASK, KEY, COLUMN, DIST, VALID = 12, 1, 4, 4, 4, 1
SCAN_EDGE_K = 5


def frame_calls(cfg) -> list[tuple[float, int, int, int, int, int]]:
    """(solves a frame, outer iterations, N targets, payload columns,
    Q queries, k) of each target set a frame searches; [] off the hash
    engine."""
    sc, lc = cfg.solver, cfg.lidar
    if sc.nn_engine != "hash":
        return []
    scan = [sc.icp_iters_odom]
    if cfg.use_deskew and not sc.ct_sweep:
        scan.append(sc.icp_iters_redeskew)
    calls = []
    for iters in scan:
        calls += [(1.0, iters, lc.k_edge * lc.target_mult, 1, lc.k_edge,
                   SCAN_EDGE_K),
                  (1.0, iters, lc.k_planar * lc.target_mult, 0, lc.k_planar,
                   sc.map_knn)]
    if cfg.use_map:
        share = 1.0 / max(cfg.map.map_every, 1)
        calls += [(share, sc.icp_iters_map, cfg.map.edge_capacity, 0,
                   lc.k_edge, sc.map_knn),
                  (share, sc.icp_iters_map, cfg.map.planar_capacity, 0,
                   lc.k_planar, sc.map_knn)]
    return calls


def build_bytes(n: int, columns: int) -> int:
    """Bytes one grid build over ``n`` targets must move."""
    return (n * (POINT + MASK + COLUMN * columns)
            + n * (KEY + POINT + COLUMN * columns))


def query_bytes(n: int, columns: int, q: int, k: int) -> int:
    """Bytes one query of ``q`` points against a grid of ``n`` must move."""
    return (q * (POINT + MASK) + n * (KEY + POINT + COLUMN * columns)
            + q * k * (POINT + COLUMN * columns + DIST + VALID))


def frame_bytes(cfg) -> float:
    """Bytes of one frame's hash search."""
    return sum(share * (build_bytes(n, cols)
                        + iters * query_bytes(n, cols, q, k))
               for share, iters, n, cols, q, k in frame_calls(cfg))


def frame_least_seconds(cfg) -> float:
    """The least time one frame's hash search takes on the card."""
    return roofline.least_seconds(frame_bytes(cfg), 0.0)
