"""Outer ICP loops: scan-to-scan and scan-to-map solves
(port of ``velo_tpu/solve/icp.py``).

Each solve is an outer loop that re-searches correspondences after every
pose update around an inner LM solve.  ``SolverConfig.nn_engine`` selects
the search: "dense" runs the global search once per target set
(``build_candidates``: the ``dist_topk`` kernel at the initial pose, 16
candidates per query) and the outer iterations re-rank only those
candidates; "hash" queries a voxel-hash grid of the targets
(``mapping.voxel_hash``) at every outer iteration, without the kernel.
Each outer iteration's correspondence fit (the rows of every query, then
edge lines and PCA planes) is :func:`_fit`: one ``corr_fit`` kernel launch
on the card.  The solved variable ``T_target_cur`` maps current-scan
coordinates into the target frame (previous scan, or map/world).  With
``vis`` (the fused path) the scan-to-scan system also carries the visual
reprojection and epipolar blocks.  ``solve_scan_to_scan_ct``
(``ct_sweep``) solves 12 DoF: the pose and the scan's own sweep motion.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from velo_tpu_torch import fp
from velo_tpu_torch.evaluation import profiling
from velo_tpu_torch.geom import linalg as lin3
from velo_tpu_torch.geom import se3
from velo_tpu_torch.kernels import corr_fit, lm_joint, lm_lidar
from velo_tpu_torch.lidar import deskew as deskew_mod
from velo_tpu_torch.mapping import dense_nn, voxel_hash
from velo_tpu_torch.mapping.dense_nn import TargetSet, make_targets  # noqa: F401
from velo_tpu_torch.solve import residuals as res
from velo_tpu_torch.solve.lm import lm_solve, lm_solve_ct

_BIG = 10**6
_MIN_CORR = 20  # degenerate-frame gate: fewer inliers => keep the prior pose
_N_CAND = 16  # candidates precomputed per query (covers pose wander)
_CAND_SLACK = 2.0  # extra search radius so candidates survive pose updates


class SolveDiag(NamedTuple):
    """Per-solve observability record."""

    n_edge: torch.Tensor
    n_planar: torch.Tensor
    cost: torch.Tensor
    degenerate: torch.Tensor
    lm_accept: torch.Tensor | int = 0  # LM steps accepted over all outer iters


class VisData(NamedTuple):
    """Depth-augmented visual tracks for the joint solve.

    Landmarks live in the *previous* velodyne frame; observations are the
    KLT positions in the current image.  The solved T maps current ->
    previous frame, so a landmark is pulled back through T^-1.
    """

    xyz_prev_velo: torch.Tensor  # (K, 3)
    obs_uv: torch.Tensor  # (K, 2)
    mask: torch.Tensor  # (K,) depth-augmented tracks (reprojection residual)
    P: torch.Tensor  # (3, 4) camera projection
    T_cam_velo: torch.Tensor  # (4, 4)
    uv_prev: torch.Tensor | None = None  # (K, 2) for the epipolar residual
    mask_nodepth: torch.Tensor | None = None  # (K,) tracks without depth
    w_scale: torch.Tensor | float = 1.0  # reprojection trust scale
    w_lm: torch.Tensor | float = 1.0  # per-landmark inverse-variance weight


class CandCache(NamedTuple):
    """Per-query candidate neighbourhoods, gathered once per frame."""

    pts: torch.Tensor  # (Q, C, 3) candidate target points per query
    payload: torch.Tensor  # (Q, C, P)
    ok: torch.Tensor  # (Q, C)


def build_candidates(targets: TargetSet, queries: torch.Tensor,
                     qmask: torch.Tensor, T_init: torch.Tensor,
                     cfg) -> CandCache:
    """Global approx-kNN preselection at the initial pose (dense engine):
    the step's ``search`` stage, wherever it is called."""
    with profiling.stage("search"):
        n_cand = min(_N_CAND, targets.pts.shape[0])
        p0 = se3.apply(T_init, queries)
        cand_idx, _, cand_ok = dense_nn.knn(
            targets, p0, qmask, k=n_cand,
            max_dist=cfg.corr_max_dist + _CAND_SLACK, approx=True,
            approx_impl=cfg.nn_approx_impl,
        )
        cand_idx = cand_idx.long()
        return CandCache(pts=targets.pts[cand_idx],
                         payload=targets.payload[cand_idx], ok=cand_ok)


def _select_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x: (Q, C, D), idx: (Q, K) -> (Q, K, D) rows of x along C."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def _cand_query(cache: CandCache, cfg):
    """query(p, mask, k) re-ranking only the cached candidates."""

    def query(p, mask, k):
        k = min(k, cache.pts.shape[1])
        diff = p[:, None, :] - cache.pts
        d2 = fp.dot3(diff, diff)
        d2 = torch.where(cache.ok & mask[:, None], d2, torch.inf)
        # Stable sort keeps lax.top_k's lower-index-first order among ties.
        neg, top = torch.sort(-d2, dim=1, descending=True, stable=True)
        neg, top = neg[:, :k], top[:, :k]
        dist2 = torch.clamp(-neg, min=0.0)
        nbr = _select_rows(cache.pts, top)
        pay = (_select_rows(cache.payload, top) if cache.payload.shape[-1]
               else cache.payload[:, :k])
        valid = torch.isfinite(dist2) & (dist2 <= cfg.corr_max_dist ** 2)
        dist = fp.sqrt(torch.where(torch.isfinite(dist2), dist2, 1e12))
        return nbr, pay, dist, valid

    return query


def _make_engine(targets: TargetSet, queries: torch.Tensor,
                 qmask: torch.Tensor, T_init: torch.Tensor, cfg,
                 cands: CandCache | None = None):
    """``rows(p, mask, k) -> corr_fit.Rows`` of ``cfg.nn_engine``: the
    dense engine's candidate cache, re-ranked by the fit, or the k rows of
    a hash query; ``cands`` reuses a caller's candidate cache (dense engine
    only)."""
    if cfg.nn_engine == "hash":
        # Stages ``hash_build`` / ``hash_query``, nested in the calling
        # solve's stage.
        with profiling.stage("hash_build"):
            # Centre the packed voxel keys on the cloud so world-frame maps
            # stay within the +/-511-cell key window.
            w = targets.mask.to(targets.pts.dtype)
            center = fp.sum(targets.pts * w[:, None], dim=0) / torch.clamp(
                fp.sum(w), min=1.0)
            grid = voxel_hash.build_grid(targets.pts, targets.mask,
                                         cfg.voxel_size, center=center,
                                         payload=targets.payload)

        def rows(p, mask, k):
            with profiling.stage("hash_query"):
                idx, _, val = voxel_hash.knn(
                    grid, p, mask, k=k, max_dist=cfg.corr_max_dist,
                    occupancy=cfg.voxel_occupancy)
                return corr_fit.Rows(grid.pts[idx], grid.payload[idx], val,
                                     k, rerank=False)

        return rows
    if cands is None:
        cands = build_candidates(targets, queries, qmask, T_init, cfg)
    return lambda p, mask, k: corr_fit.Rows(
        cands.pts, cands.payload, cands.ok, min(k, cands.pts.shape[1]),
        rerank=True)


def _edge_lines_2pt(query, p, mask):
    """Nearest + nearest-on-a-different-ring target points for each edge."""
    nbr, pay, dist, val = query(p, mask, 5)
    ring = pay[..., 0]
    a_ok = val[:, 0]
    diff = val & (ring != ring[:, :1])
    order = torch.arange(nbr.shape[1], dtype=torch.int32, device=p.device)
    j_b = torch.argmin(torch.where(diff, order[None, :], _BIG), dim=1)
    b_ok = torch.any(diff, dim=1)
    a = nbr[:, 0]
    b = _select_rows(nbr, j_b[:, None])[:, 0]
    return a, b, mask & a_ok & b_ok


def _planar_planes_fit(query, p, mask, k):
    """Gated PCA plane over the k nearest target planar points ->
    (n, d, ok, quality)."""
    nbr, _, dist, val = query(p, mask, k)
    n, d, ok, q = res.fit_plane_eig(nbr, val)
    return n, d, ok & mask & (val.sum(dim=1) >= 3), q


def _fit(eq, pq, pe, e_mask, pp, p_mask, cfg, line=False) -> corr_fit.Fit:
    """One outer iteration's correspondences at the moved edges ``pe`` and
    planars ``pp``, from the engines ``eq`` / ``pq``: the 2-point edge
    lines (or with ``line`` the map solve's PCA lines) and the PCA planes.
    On the card one ``corr_fit`` launch, counted as ``fit.kernel``;
    elsewhere its plain version, ``fit.plain``."""
    e_rows = eq(pe, e_mask, cfg.map_knn if line else 5)
    p_rows = pq(pp, p_mask, cfg.map_knn)
    if pe.device.type == "cuda":
        profiling.add("fit.kernel")
        return corr_fit.corr_fit(e_rows, pe, e_mask, p_rows, pp, p_mask, cfg,
                                 line=line)
    profiling.add("fit.plain")
    return corr_fit.corr_fit_reference(e_rows, pe, e_mask, p_rows, pp,
                                       p_mask, cfg, line=line)


def _prior_weights(cfg, prior_T, prior_scale):
    if prior_T is None or (cfg.prior_weight_trans <= 0
                           and cfg.prior_weight_rot <= 0):
        return None, None
    w = fp.const([cfg.prior_weight_trans] * 3 + [cfg.prior_weight_rot] * 3,
                 torch.float32, prior_T.device)
    w = w * (1.0 if prior_scale is None else prior_scale)
    return w, se3.inv(prior_T)


def _prior_terms6(T, cfg, w_prior, prior_inv, H_obs):
    """(H, g, cost) of the dead-zone motion prior.  ``H_obs`` is the
    prior-less Hessian (geometric + visual) that the observability-scaled
    prior eigen-analyzes."""
    r_pr = se3.log(se3.compose(T, prior_inv))
    if cfg.prior_obs_gain > 0.0:
        return _obs_scaled_prior(cfg, w_prior, r_pr, H_obs)

    def _dz(r3, dz):
        n = fp.norm3(r3)
        scale = torch.clamp(1.0 - dz / torch.clamp(n, min=1e-9), min=0.0)
        return r3 * scale, (n > dz).to(r3.dtype)

    r_t, a_t = _dz(r_pr[:3], cfg.prior_deadzone_trans)
    r_r, a_r = _dz(r_pr[3:], cfg.prior_deadzone_rot)
    r_eff = torch.cat([r_t, r_r])
    active = torch.cat([a_t.expand(3), a_r.expand(3)])
    H = torch.diag(w_prior * active)
    g = w_prior * r_eff
    return H, g, 0.5 * fp.sum(w_prior * r_eff * r_eff)


def _vis_terms6(T, cfg, vis: VisData):
    """(H, g, cost) of the visual blocks (the visual half of the
    reference's ``_vis_prior_terms6``): Huber-weighted reprojection of the
    depth-augmented tracks and, for tracks without depth, the epipolar
    residual."""
    H = torch.zeros((6, 6), dtype=T.dtype, device=T.device)
    g = torch.zeros((6,), dtype=T.dtype, device=T.device)
    cost = torch.zeros((), dtype=T.dtype, device=T.device)
    T_inv = se3.inv(T)
    # Reprojection: r = pi(P, T_cv T^-1 X_prev) - obs, with the left-
    # perturbation chain dX_cam/dxi = -R_cv R^T [I | -hat(X_prev)].
    Y = se3.apply(T_inv, vis.xyz_prev_velo)
    X_cam = se3.apply(vis.T_cam_velo, Y)
    rv, dr_dX, okv = res.reprojection(X_cam, vis.P, vis.obs_uv, vis.mask)
    A = -fp.matmul(vis.T_cam_velo[:3, :3], T[:3, :3].T)
    dX_dxi = fp.einsum("ij,kjl->kil", A,
                       res.point_jacobian(vis.xyz_prev_velo))  # (K,3,6)
    Jv = fp.einsum("kri,kil->krl", dr_dX, dX_dxi)  # (K,2,6)
    rnorm = fp.norm(rv)
    # Huber, not a redescending loss: a badly wrong prediction makes every
    # visual residual large in the same direction, and that is signal.
    wv = (res.huber_weight(rnorm, cfg.huber_delta_repr) * okv * vis.w_lm
          * (cfg.vis_weight * vis.w_scale))
    H = H + fp.einsum("k,kri,krj->ij", wv, Jv, Jv)
    g = g + fp.einsum("k,kri,kr->i", wv, Jv, rv)
    cost = cost + cfg.vis_weight * vis.w_scale * fp.sum(
        res.huber_cost(rnorm, cfg.huber_delta_repr) * okv * vis.w_lm)

    if vis.uv_prev is not None and cfg.epi_weight > 0:
        # Depth-unknown tracks: M = T_cv T^-1 T_vc (prev cam -> cur cam).
        Kmat = vis.P[:3, :3]
        T_vc = se3.inv(vis.T_cam_velo)
        A4 = se3.compose(vis.T_cam_velo, T_inv)
        re_, oke_ = res.epipolar(se3.compose(A4, T_vc), Kmat, vis.uv_prev,
                                 vis.obs_uv, vis.mask_nodepth)
        Jep = res.epipolar_jacobian(A4, T_vc, Kmat, vis.uv_prev, vis.obs_uv,
                                    oke_)  # (K, 6)
        wep = res.huber_weight(re_, cfg.huber_delta_repr) * oke_ \
            * cfg.epi_weight
        H = H + fp.einsum("k,ki,kj->ij", wep, Jep, Jep)
        g = g + fp.einsum("k,ki,k->i", wep, Jep, re_)
        cost = cost + cfg.epi_weight * fp.sum(
            res.huber_cost(re_, cfg.huber_delta_repr) * oke_)
    return H, g, cost


def _chain(dr: torch.Tensor, J: torch.Tensor) -> torch.Tensor:
    """(K,3) dr/dp times (K,3,6) dp/dxi -> (K,6), summed in a fixed order."""
    return (dr[:, 0:1] * J[:, 0] + dr[:, 1:2] * J[:, 1]) + dr[:, 2:3] * J[:, 2]


def make_lidar_system(edges, edge_mask, line_a, line_b, line_ok,
                      planars, planar_mask, pl_n, pl_d, pl_ok, cfg,
                      vis: VisData | None = None, edge_q=None, planar_q=None,
                      prior_T=None, prior_scale=None):
    """Closure: T -> (H, g, cost) for fixed LiDAR (+ visual) correspondences.

    ``vis`` adds the visual blocks; ``edge_q`` / ``planar_q`` are
    per-correspondence fit-quality weights in [0,1]; ``prior_T`` adds the
    dead-zone constant-velocity motion prior.
    """
    w_prior, prior_inv = _prior_weights(cfg, prior_T, prior_scale)

    def build(T):
        pe = se3.apply(T, edges)
        re, dre, oke = res.point_to_line(pe, line_a, line_b,
                                         line_ok & edge_mask)
        we = res.robust_weight(re, cfg.huber_delta_icp, cfg.icp_loss) * oke
        if edge_q is not None:
            we = we * edge_q
        Je = _chain(dre, res.point_jacobian(pe))

        pp = se3.apply(T, planars)
        rp, drp, okp = res.point_to_plane(pp, pl_n, pl_d, pl_ok & planar_mask)
        wp = res.robust_weight(rp, cfg.huber_delta_icp, cfg.icp_loss) * okp
        if planar_q is not None:
            wp = wp * planar_q
        Jp = _chain(drp, res.point_jacobian(pp))

        H = (fp.matmul((Je * we[:, None]).T, Je)
             + fp.matmul((Jp * wp[:, None]).T, Jp))
        g = (fp.matmul(Je.T, (we * re)[:, None])
             + fp.matmul(Jp.T, (wp * rp)[:, None]))[:, 0]
        cost = fp.sum(
            res.robust_cost(re, cfg.huber_delta_icp, cfg.icp_loss) * oke
        ) + fp.sum(
            res.robust_cost(rp, cfg.huber_delta_icp, cfg.icp_loss) * okp)
        if vis is not None:
            Hv, gv, cv = _vis_terms6(T, cfg, vis)
            H, g, cost = H + Hv, g + gv, cost + cv
        if w_prior is None:
            return H, g, cost
        Ha, ga, ca = _prior_terms6(T, cfg, w_prior, prior_inv, H)
        return H + Ha, g + ga, cost + ca

    return build


class ObsBasis(NamedTuple):
    """Observability eigenbasis + per-direction prior weights, derived at
    an LM linearization point and frozen for that iteration's trial costs."""

    V: torch.Tensor  # (2, 3, 3) eigenvectors, [trans, rot] blocks
    w: torch.Tensor  # (2, 3) per-eigendirection prior weights
    dz: torch.Tensor  # (2, 3) per-eigendirection dead zones


def obs_prior_basis(cfg, w_prior, H_obs) -> ObsBasis:
    """Eigen-analyze H_obs's trans/rot 3x3 blocks into an :class:`ObsBasis`.

    Along eigendirection i with obs_i = clip((lam_i/lam_max)/prior_obs_ref,
    0, 1) the prior gets weight w_base*(1 + gain*(1 - obs_i)) and dead zone
    dz_base*(floor + (1-floor)*obs_i).
    """
    B = torch.stack([H_obs[:3, :3], H_obs[3:6, 3:6]])
    evals, V = lin3.sym_eig3x3(0.5 * (B + B.transpose(-1, -2)))
    s = evals / torch.clamp(evals[..., 2:3], min=1e-12)
    obs = torch.clamp(fp.div(s, cfg.prior_obs_ref), 0.0, 1.0)
    w_base = torch.stack([w_prior[0], w_prior[3]])[:, None]
    dz_base = fp.const([cfg.prior_deadzone_trans, cfg.prior_deadzone_rot],
                       H_obs.dtype, H_obs.device)[:, None]
    w_i = w_base * (1.0 + cfg.prior_obs_gain * (1.0 - obs))
    dz_i = dz_base * (cfg.prior_obs_dz_floor
                      + (1.0 - cfg.prior_obs_dz_floor) * obs)
    return ObsBasis(V=V, w=w_i, dz=dz_i)


def _obs_prior_terms(basis: ObsBasis, r_pr):
    """(H, g, cost) of the anisotropic dead-zone prior in a fixed basis."""
    r = torch.stack([r_pr[:3], r_pr[3:]])  # (2, 3)
    r_v = fp.einsum("bij,bi->bj", basis.V, r)  # V^T r per block
    r_eff = r_v - torch.minimum(torch.maximum(r_v, -basis.dz), basis.dz)
    active = (torch.abs(r_v) > basis.dz).to(r_v.dtype)
    Hb = fp.einsum("bik,bk,bjk->bij", basis.V, basis.w * active, basis.V)
    gb = fp.einsum("bij,bj->bi", basis.V, basis.w * r_eff)
    H = torch.block_diag(Hb[0], Hb[1])
    g = torch.cat([gb[0], gb[1]])
    return H, g, 0.5 * fp.sum(basis.w * r_eff * r_eff)


def _obs_scaled_prior(cfg, w_prior, r_pr, H_obs):
    """Dynamic-basis form: eigen-analyze H_obs in place, then apply."""
    return _obs_prior_terms(obs_prior_basis(cfg, w_prior, H_obs), r_pr)


def _obs_prior_active(cfg, prior_T) -> bool:
    """Whether the observability-scaled prior is active: a prior pose, a
    positive ``prior_obs_gain`` and a positive prior weight.  Exactly then
    :func:`_make_stage` returns a stage."""
    return (prior_T is not None and cfg.prior_obs_gain > 0.0
            and (cfg.prior_weight_trans > 0 or cfg.prior_weight_rot > 0))


def _use_deferred(cfg, prior_T) -> bool:
    """Routing of ``prior_obs_impl="deferred"`` / ``"deferred_tail"``: the
    deferred-reject LM loops apply exactly when the obs-scaled prior is
    active."""
    return (cfg.prior_obs_impl in ("deferred", "deferred_tail")
            and _obs_prior_active(cfg, prior_T))


def _kernel_route(cfg, prior_T, vis, device: torch.device) -> bool:
    """Whether :func:`_solve` runs its LM solves as one kernel launch each:
    on the card, on the staged route (the obs-scaled prior active and not
    deferred), without the degeneracy remap and with a loss the kernels
    compute; ``lm_lidar`` for the LiDAR-only system, ``lm_joint`` for the
    6-DoF system with ``vis`` (not the 12-DoF one of ``ct_sweep``)."""
    return (device.type == "cuda" and (vis is None or not cfg.ct_sweep)
            and _obs_prior_active(cfg, prior_T)
            and not _use_deferred(cfg, prior_T)
            and cfg.degen_rel_min <= 0.0 and cfg.icp_loss in lm_lidar.LOSSES)


def _make_stage(cfg, prior_T, prior_scale, build_noprior):
    """Per-LM-iteration observability staging for :func:`lm_solve`.

    Returns ``stage(T, basis=None) -> (H, g, cost, trial_cost, basis)``, or
    None when the obs-scaled prior is inactive.  ``basis=None`` re-derives
    the prior's eigenbasis from the prior-less Hessian at T; either way the
    iteration's ``trial_cost`` scores the prior in that frozen basis.
    """
    if not _obs_prior_active(cfg, prior_T):
        return None
    w_pr, prior_inv = _prior_weights(cfg, prior_T, prior_scale)
    return obs_stage(cfg, w_pr, prior_inv, build_noprior)


def obs_stage(cfg, w_pr, prior_inv, build_noprior):
    """:func:`_make_stage`'s stage from the prior's scaled weights ``w_pr``
    (6,) and inverse pose ``prior_inv`` (``_prior_weights``)."""

    def stage(T, basis=None):
        H0, g0, c0 = build_noprior(T)
        if basis is None:
            basis = obs_prior_basis(cfg, w_pr, H0)

        def prior_terms(T_at):
            return _obs_prior_terms(basis,
                                    se3.log(se3.compose(T_at, prior_inv)))

        Hp, gp, cp = prior_terms(T)

        def trial_cost(T_try):
            return build_noprior(T_try)[2] + prior_terms(T_try)[2]

        return H0 + Hp, g0 + gp, c0 + cp, trial_cost, basis

    return stage


def _empty_diag(dev) -> SolveDiag:
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    return SolveDiag(n_edge=zero, n_planar=zero,
                     cost=torch.zeros((), device=dev),
                     degenerate=torch.zeros((), dtype=torch.bool, device=dev),
                     lm_accept=zero)


def _solve(edges, edge_mask, planars, planar_mask, T_init, cfg, outer,
           prior_T, prior_scale, fit, vis=None):
    """The outer loop shared by both solves: ``fit(T) -> (a, b, e_ok, n, d,
    p_ok, quality_kw)`` re-searches correspondences at T, then LM runs on
    them (and on ``vis``'s visual blocks): with the staged obs prior, with
    the deferred-reject loop on the full dynamic system
    (``prior_obs_impl="deferred"``) or on the stage (``"deferred_tail"``),
    or on the classic system when the obs prior is inactive.  On the card
    the staged solve is one kernel launch (:func:`_kernel_route`):
    ``lm_lidar``, or ``lm_joint`` with ``vis``; ``profiling`` counts each
    solve as ``lm.kernel`` or ``lm.plain``."""
    T = T_init
    diag = _empty_diag(T_init.device)
    kernel = _kernel_route(cfg, prior_T, vis, T_init.device)
    if kernel:
        w_pr, prior_inv = _prior_weights(cfg, prior_T, prior_scale)
        prep = None if vis is None else lm_joint.prepare(vis, cfg)
    for _ in range(outer):
        a, b, e_ok, n, d, p_ok, q_kw = fit(T)
        n_e = torch.sum(e_ok, dtype=torch.int32)
        n_p = torch.sum(p_ok, dtype=torch.int32)
        enough = (n_e + n_p) >= _MIN_CORR
        if kernel:
            profiling.add("lm.kernel")
            corr = (T, prior_inv, w_pr, edges, edge_mask, a, b, e_ok, planars,
                    planar_mask, n, d, p_ok)
            st = (lm_lidar.lm_lidar(*corr, cfg, **q_kw) if vis is None else
                  lm_joint.lm_joint(*corr, vis, cfg, **q_kw, prepared=prep))
            T_new = st.T
        else:
            profiling.add("lm.plain")
            corr = (edges, edge_mask, a, b, e_ok, planars, planar_mask, n, d,
                    p_ok, cfg)
            deferred = _use_deferred(cfg, prior_T)
            stage = (None if deferred and cfg.prior_obs_impl == "deferred"
                     else _make_stage(cfg, prior_T, prior_scale,
                                      make_lidar_system(*corr, vis=vis,
                                                        **q_kw)))
            build = None if stage is not None else make_lidar_system(
                *corr, vis=vis, prior_T=prior_T, prior_scale=prior_scale,
                **q_kw)
            T_new, st = lm_solve(build, T, cfg, stage=stage,
                                 deferred=deferred)
        T = torch.where(enough, T_new, T)
        diag = SolveDiag(n_edge=n_e, n_planar=n_p, cost=st.cost,
                         degenerate=~enough,
                         lm_accept=diag.lm_accept + st.n_accept)
    return T, diag


def solve_scan_to_scan(cur_edges, cur_edge_mask, cur_planars,
                       cur_planar_mask, edge_targets: TargetSet,
                       planar_targets: TargetSet, T_init, cfg,
                       iters: Optional[int] = None,
                       vis: Optional[VisData] = None,
                       edge_cands: Optional[CandCache] = None,
                       planar_cands: Optional[CandCache] = None,
                       prior_T=None, prior_scale=None):
    """LOAM odometry solve: current features vs previous-scan targets.

    ``edge_targets.payload[:, 0]`` carries ring indices (the different-ring
    rule of the 2-point edge lines).  With ``vis`` the visual residuals
    join the cost (the vision-enhanced joint solve).  Returns
    (T_target_cur, SolveDiag).
    """
    outer = cfg.icp_iters_odom if iters is None else iters
    eq = _make_engine(edge_targets, cur_edges, cur_edge_mask, T_init, cfg,
                      cands=edge_cands)
    pq = _make_engine(planar_targets, cur_planars, cur_planar_mask, T_init,
                      cfg, cands=planar_cands)

    def fit(T):
        f = _fit(eq, pq, se3.apply(T, cur_edges), cur_edge_mask,
                 se3.apply(T, cur_planars), cur_planar_mask, cfg)
        return f.a, f.b, f.e_ok, f.n, f.d, f.p_ok, {"planar_q": f.p_q}

    return _solve(cur_edges, cur_edge_mask, cur_planars, cur_planar_mask,
                  T_init, cfg, outer, prior_T, prior_scale, fit, vis=vis)


def solve_scan_to_map(cur_edges, cur_edge_mask, cur_planars,
                      cur_planar_mask, edge_targets: TargetSet,
                      planar_targets: TargetSet, T_init, cfg,
                      iters: Optional[int] = None, prior_T=None,
                      prior_scale=None):
    """LOAM mapping solve: eigen line/plane fits over k-NN in the local map."""
    outer = cfg.icp_iters_map if iters is None else iters
    eq = _make_engine(edge_targets, cur_edges, cur_edge_mask, T_init, cfg)
    pq = _make_engine(planar_targets, cur_planars, cur_planar_mask, T_init,
                      cfg)

    def fit(T):
        f = _fit(eq, pq, se3.apply(T, cur_edges), cur_edge_mask,
                 se3.apply(T, cur_planars), cur_planar_mask, cfg, line=True)
        return (f.a, f.b, f.e_ok, f.n, f.d, f.p_ok,
                {"edge_q": f.e_q, "planar_q": f.p_q})

    return _solve(cur_edges, cur_edge_mask, cur_planars, cur_planar_mask,
                  T_init, cfg, outer, prior_T, prior_scale, fit)


def _make_stage_ct(cfg, prior_T, prior_scale, build_noprior):
    """12-DoF variant of :func:`_make_stage` for :func:`lm_solve_ct`; the
    prior touches only the pose block of the (12, 12) system."""
    if not _obs_prior_active(cfg, prior_T):
        return None
    w_pr, prior_inv = _prior_weights(cfg, prior_T, prior_scale)

    def stage(T, xi2, basis=None):
        H0, g0, c0 = build_noprior(T, xi2)
        if basis is None:
            basis = obs_prior_basis(cfg, w_pr, H0[:6, :6])

        def prior_terms(T_at):
            return _obs_prior_terms(basis,
                                    se3.log(se3.compose(T_at, prior_inv)))

        Hp, gp, cp = prior_terms(T)

        def trial_cost(T_try, xi2_try):
            return build_noprior(T_try, xi2_try)[2] + prior_terms(T_try)[2]

        return (H0 + _pad12(Hp), g0 + _pad12(gp), c0 + cp, trial_cost,
                basis)

    return stage


def _pad12(x: torch.Tensor) -> torch.Tensor:
    """A pose-block term, (6, 6) or (6,), as its (12, 12) or (12,) part:
    added out of place, so the sum also runs under vmap."""
    return torch.nn.functional.pad(x, (0, 6) * x.dim())


def make_lidar_system_ct(edges_base, edge_phase, edge_mask, line_a, line_b,
                         line_ok, planars_base, planar_phase, planar_mask,
                         pl_n, pl_d, pl_ok, xi_ref, cfg,
                         vis: VisData | None = None, edge_q=None,
                         planar_q=None, prior_T=None, prior_scale=None):
    """12-DoF continuous-time system: ``build(T, xi2) -> (H (12,12), g
    (12,), cost)`` over the pose T and the current scan's own sweep motion
    xi2.

    A feature measured at phase s maps through ``T @ exp(s*xi2)``, so the
    distortion field is estimated from the scan itself; ``xi_ref`` is the
    motion the features were deskewed with before extraction, and
    ``build`` re-expresses them for any xi2 by a redeskew.  A coupling
    prior ``xi2 ~ log(T)`` (constant velocity across the two
    half-intervals) conditions the extra 6 DoF where the geometry cannot.
    The visual blocks and the motion prior touch only the pose block
    (camera observations are global-shutter).
    """
    w_prior, prior_inv = _prior_weights(cfg, prior_T, prior_scale)
    dev = edges_base.device
    w_couple = fp.const(
        [cfg.couple_weight_trans] * 3 + [cfg.couple_weight_rot] * 3,
        torch.float32, dev)
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    Jc = torch.cat([-eye6, eye6], dim=1)  # (6, 12) d(xi2 - log T)

    def lidar_block(base, phase, mask, fit_res, q, T, xi2):
        cur = deskew_mod.redeskew(base, phase, xi_ref, xi2)
        cur = torch.where(mask[:, None], cur, 0.0)
        p = se3.apply(T, cur)
        r, dr_dp, ok = fit_res(p)
        w = res.robust_weight(r, cfg.huber_delta_icp, cfg.icp_loss) * ok
        if q is not None:
            w = w * q
        J1 = _chain(dr_dp, res.point_jacobian(p))
        # dp'/dxi2 = s * R_T [I | -hat(cur)]  (first order in the
        # per-point angle).
        dp2 = fp.einsum("ab,kbj->kaj", T[:3, :3],
                        res.point_jacobian(cur)) * phase[:, None, None]
        J = torch.cat([J1, _chain(dr_dp, dp2)], dim=-1)  # (K, 12)
        H = fp.matmul((J * w[:, None]).T, J)
        g = fp.matmul(J.T, (w * r)[:, None])[:, 0]
        cost = fp.sum(
            res.robust_cost(r, cfg.huber_delta_icp, cfg.icp_loss) * ok)
        return H, g, cost

    def build(T, xi2):
        He, ge, ce = lidar_block(
            edges_base, edge_phase, edge_mask,
            lambda p: res.point_to_line(p, line_a, line_b,
                                        line_ok & edge_mask),
            edge_q, T, xi2)
        Hp, gp, cp = lidar_block(
            planars_base, planar_phase, planar_mask,
            lambda p: res.point_to_plane(p, pl_n, pl_d, pl_ok & planar_mask),
            planar_q, T, xi2)
        H, g, cost = He + Hp, ge + gp, ce + cp

        # Constant-velocity coupling of the inter-frame and the intra-sweep
        # motion.
        r_c = xi2 - se3.log(T)
        H = H + fp.matmul(Jc.T * w_couple[None, :], Jc)
        g = g + fp.matmul(Jc.T, (w_couple * r_c)[:, None])[:, 0]
        cost = cost + 0.5 * fp.sum(w_couple * r_c * r_c)

        # The pose block's visual and prior terms, as the reference's
        # _vis_prior_terms6: the prior's observability source is the
        # geometric pose block plus the visual blocks.
        Ha = torch.zeros((6, 6), dtype=T.dtype, device=T.device)
        ga = torch.zeros((6,), dtype=T.dtype, device=T.device)
        ca = torch.zeros((), dtype=T.dtype, device=T.device)
        if vis is not None:
            Ha, ga, ca = _vis_terms6(T, cfg, vis)
        if w_prior is not None:
            Hr, gr, cr = _prior_terms6(T, cfg, w_prior, prior_inv,
                                       H[:6, :6] + Ha)
            Ha, ga, ca = Ha + Hr, ga + gr, ca + cr
        return H + _pad12(Ha), g + _pad12(ga), cost + ca

    return build


def solve_scan_to_scan_ct(edges_base, edge_phase, edge_mask, planars_base,
                          planar_phase, planar_mask,
                          edge_targets: TargetSet, planar_targets: TargetSet,
                          T_init, xi_ref, cfg, iters: Optional[int] = None,
                          vis: Optional[VisData] = None,
                          edge_cands: Optional[CandCache] = None,
                          planar_cands: Optional[CandCache] = None,
                          prior_T=None, prior_scale=None):
    """Continuous-time scan-to-scan solve: returns (T, xi2, SolveDiag).

    Replaces the (solve -> redeskew -> re-solve) fixed point of the 6-DoF
    path: the sweep motion is estimated jointly, so one solve registers
    the scan and undistorts it.  ``xi_ref`` is the prediction the features
    were deskewed with, and xi2's initial value.
    """
    outer = cfg.icp_iters_odom if iters is None else iters
    eq = _make_engine(edge_targets, edges_base, edge_mask, T_init, cfg,
                      cands=edge_cands)
    pq = _make_engine(planar_targets, planars_base, planar_mask, T_init,
                      cfg, cands=planar_cands)
    T, xi2 = T_init, xi_ref
    diag = _empty_diag(T_init.device)
    for _ in range(outer):
        e_cur = torch.where(edge_mask[:, None], deskew_mod.redeskew(
            edges_base, edge_phase, xi_ref, xi2), 0.0)
        p_cur = torch.where(planar_mask[:, None], deskew_mod.redeskew(
            planars_base, planar_phase, xi_ref, xi2), 0.0)
        a, b, e_ok, _, n, d, p_ok, p_q = _fit(
            eq, pq, se3.apply(T, e_cur), edge_mask, se3.apply(T, p_cur),
            planar_mask, cfg)
        corr = (edges_base, edge_phase, edge_mask, a, b, e_ok, planars_base,
                planar_phase, planar_mask, n, d, p_ok, xi_ref, cfg)
        stage = _make_stage_ct(cfg, prior_T, prior_scale,
                               make_lidar_system_ct(*corr, vis=vis,
                                                    planar_q=p_q))
        build = None if stage is not None else make_lidar_system_ct(
            *corr, vis=vis, planar_q=p_q, prior_T=prior_T,
            prior_scale=prior_scale)
        n_e = torch.sum(e_ok, dtype=torch.int32)
        n_p = torch.sum(p_ok, dtype=torch.int32)
        enough = (n_e + n_p) >= _MIN_CORR
        T_new, xi2_new, st = lm_solve_ct(build, T, xi2, cfg, stage=stage)
        T = torch.where(enough, T_new, T)
        xi2 = torch.where(enough, xi2_new, xi2)
        diag = SolveDiag(n_edge=n_e, n_planar=n_p, cost=st.cost,
                         degenerate=~enough,
                         lm_accept=diag.lm_accept + st.n_accept)
    return T, xi2, diag
