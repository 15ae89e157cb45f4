"""Work of the ``lm_lidar`` kernel per odometry frame, counted from the
shapes and iterations the configuration fixes (frozen from
``chip_smoke.py``'s bound, its ``LM_*`` constants).

One launch runs one Levenberg-Marquardt solve of the 6-DoF LiDAR system:
``lm_iters`` iterations, each a full pass over every correspondence (its
float64 operations: 43 products into 43 sums and ~6 rounding helpers of
~3 operations) and a cost-only pass (the helpers and one sum).  Bytes:
one read of each correspondence (an edge: point, two line points, two
masks, 38 B; a planar: point, normal, offset, two masks, 30 B; 4 B more
for a quality weight where the solve has one: the passes re-read them
from L2), of the starting pose, the prior's inverse and weights, and one
write of the state (T, lambda, cost, converged, last step, accepted
steps).

A frame routes to the kernel the solves of the LiDAR-only system on the
staged observability-prior route, with a loss the kernel computes and no
degeneracy remap (``solve/icp._kernel_route``): each scan-to-map solve
(``icp_iters_map`` on the frames the map refines, with edge and planar
quality weights) and, where the scan-to-scan solve carries no visual
blocks and solves 6 DoF, its ``icp_iters_odom`` solves and the redeskew's
``icp_iters_redeskew`` (planar weights only): 9 a LiDAR frame, 3 fused.
Every solve counts its ``k_edge`` edges and ``k_planar`` planars.
"""
from __future__ import annotations

from benchmarks import roofline

EDGE_BYTES, PLANAR_BYTES, QUALITY_BYTES = 38, 30, 4
SOLVE_BYTES = 64 + 64 + 24 + (64 + 4 + 4 + 1 + 4 + 4)
FULL_F64_OPS, COST_F64_OPS = 2 * 43 + 18, 18 + 1
LOSSES = ("huber", "cauchy")


def frame_calls(cfg) -> list[tuple[float, tuple[int, int, bool, bool]]]:
    """(solves a frame, (edges, planars, edge weights, planar weights)) of
    each kind of solve a frame routes to the kernel, the scan-to-map kind
    averaged over the map's cadence; [] where the route is off."""
    sc, lc = cfg.solver, cfg.lidar
    prior = sc.prior_obs_gain > 0.0 and (sc.prior_weight_trans > 0
                                         or sc.prior_weight_rot > 0)
    if not (prior and sc.prior_obs_impl == "staged"
            and sc.degen_rel_min <= 0.0 and sc.icp_loss in LOSSES):
        return []
    calls = []
    if cfg.use_map:
        calls.append((sc.icp_iters_map / max(cfg.map.map_every, 1),
                      (lc.k_edge, lc.k_planar, True, True)))
    if not cfg.use_vision and not (cfg.use_deskew and sc.ct_sweep):
        scan = sc.icp_iters_odom + (sc.icp_iters_redeskew
                                    if cfg.use_deskew else 0)
        calls.append((scan, (lc.k_edge, lc.k_planar, False, True)))
    return calls


def call_work(edges: int, planars: int, edge_q: bool, planar_q: bool,
              iters: int) -> tuple[float, float]:
    """(bytes, float64 operations) of one solve."""
    n_bytes = (edges * (EDGE_BYTES + QUALITY_BYTES * edge_q)
               + planars * (PLANAR_BYTES + QUALITY_BYTES * planar_q)
               + SOLVE_BYTES)
    return n_bytes, iters * (edges + planars) * (FULL_F64_OPS + COST_F64_OPS)


def frame_least_seconds(cfg) -> float:
    """The least time the kernel's work of one frame takes on the card."""
    return sum(n * roofline.least_seconds_f64(*call_work(
        *shape, cfg.solver.lm_iters)) for n, shape in frame_calls(cfg))
