"""Odometry step and frame loop (port of ``velo_tpu/pipeline/odometry.py``).

Per frame: deskew the host-pre-binned (R, W, 5) grid into a range image
(or, with ``prebin_host=False``, deskew the padded raw scan and scatter it
into the grid on the device) -> curvature -> edge/planar features ->
[fused: image pyramid, forward-
backward KLT of the track table, consensus pre-gate of the depth tracks]
-> one candidate search per target set -> scan-to-scan solve (+ visual
reprojection and epipolar blocks), redeskew, re-solve -> plausibility gate
-> scan-to-map refinement -> velocity update -> map insert/maintain ->
[fused: LiDAR depth at the tracked pixels, corner replenishment].

The solver variants of ``SolverConfig``: ``ct_sweep`` replaces the
solve / redeskew / re-solve with one 12-DoF solve of the pose and the
scan's own sweep motion; ``deskew_exact_lag`` re-corrects the previous
scan's targets with the motion solved now and inserts the previous scan
into the map one frame late, at its exact motion; ``nn_engine="hash"``
searches correspondences in a voxel-hash grid instead of through the
``dist_topk`` kernel.

``use_vision=True`` is the fused, vision-enhanced pipeline; with
``klt_impl="pallas"`` its level-0 KLT runs the ``kernels.klt_l0`` kernel.
The carry is a fixed-shape tuple of tensors on one device.  The
reference's ``lax.cond`` cadences (map refinement every k frames, map
maintenance every k frames) become Python branches on ``frame_host``, a
host-side copy of the frame counter; data-dependent gates (has_map,
map_applied, implausible) stay ``torch.where``, so a step never waits for
the device and captures into a CUDA graph: on the card ``jit_step``,
``run_scan`` and ``run_sequence`` replay one graph per cadence key
(``cadence_key``, ``pipeline/graphs.py``).  ``init_carry`` and
``run_sequence`` run on the card unless the caller passes another device.

The step's blocks are the stages of ``evaluation/profiling.STAGES``
(``profiling.stage``): lidar_front (1-2), vision_front (2v), solve (3,
the plausibility gate included; ``icp.build_candidates`` nests a search
stage wherever it runs, the hash engine a hash_build stage per grid and
a hash_query stage per query), map_refine (4), map_update (5-7),
vision_book (8).  In a captured graph each opens with a mark kernel, so
the device trace times every stage of a replayed frame.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from velo_tpu_torch import fp
from velo_tpu_torch.evaluation import profiling
from velo_tpu_torch.geom import camera as cam_mod
from velo_tpu_torch.geom import se3
from velo_tpu_torch.lidar import curvature as curv_mod
from velo_tpu_torch.lidar import deskew as deskew_mod
from velo_tpu_torch.lidar import features as feat_mod
from velo_tpu_torch.lidar import rangeimage as ri_mod
from velo_tpu_torch.mapping import dense_nn, local_map
from velo_tpu_torch.pipeline import graphs
from velo_tpu_torch.solve import icp
from velo_tpu_torch.solve import residuals as res
from velo_tpu_torch.vision import corners as corners_mod
from velo_tpu_torch.vision import depth_assoc
from velo_tpu_torch.vision import klt as klt_mod
from velo_tpu_torch.vision import pyramid as pyr_mod
from velo_tpu_torch.vision import tracks as tracks_mod

class VisionCarry(NamedTuple):
    pyr: tuple  # previous image pyramid
    grads: tuple  # per-level (gx, gy) of the previous pyramid
    tracks: tracks_mod.TrackTable


class OdomCarry(NamedTuple):
    T_w: torch.Tensor  # (4,4) world-from-current-scan-start pose
    delta: torch.Tensor  # (6,) last frame-to-frame motion (xi of T_prev_cur)
    prev_edges: torch.Tensor  # (K_e, 3) previous-scan edge features
    prev_edge_mask: torch.Tensor
    prev_edge_ring: torch.Tensor  # (K_e,) int32
    prev_edge_phase: torch.Tensor  # (K_e,) sweep phase in [0,1)
    prev_planars: torch.Tensor  # (K_p, 3)
    prev_planar_mask: torch.Tensor
    prev_planar_phase: torch.Tensor  # (K_p,)
    edge_map: local_map.LocalMap
    planar_map: local_map.LocalMap
    frame_idx: torch.Tensor  # scalar int32, on the device
    vision: VisionCarry | None = None  # fused path only
    frame_host: int = 0  # the same counter on the host (cadence branches)


class FrameResult(NamedTuple):
    """Per-frame diagnostics, all 0-d tensors on the carry's device."""

    T_w: torch.Tensor  # (4,4) pose of this frame (velodyne frame)
    n_edge: torch.Tensor
    n_planar: torch.Tensor
    cost: torch.Tensor
    degenerate: torch.Tensor
    lm_accept: torch.Tensor  # LM steps accepted in the final s2s solve
    lm_accept_map: torch.Tensor  # same for the scan-to-map refinement
    implausible: torch.Tensor  # plausibility gate fired
    map_applied: torch.Tensor  # scan-to-map correction applied
    prior_active: torch.Tensor  # motion outside the prior's dead zone
    n_depth: torch.Tensor  # depth tracks past the pre-gate (0: no vision)
    vis_w_scale: torch.Tensor  # reprojection trust scale (1: no vision)


# What a frame's diagnostics read when the frame predates them (the
# defaults of the reference's ``FrameResult``).
_RESULT_DEFAULTS = dict(
    n_edge=0, n_planar=0, cost=0.0, degenerate=False, lm_accept=0,
    lm_accept_map=0, implausible=False, map_applied=False,
    prior_active=False, n_depth=0, vis_w_scale=1.0)


def check_slice(cfg) -> None:
    """Raise ValueError for an unknown ``klt_impl`` or ``nn_approx_impl``
    before any work."""
    if cfg.use_vision:
        klt_mod.check_impl(cfg.vision)
    if cfg.solver.nn_approx_impl not in dense_nn.APPROX_IMPLS:
        raise ValueError(
            f"unknown nn_approx_impl {cfg.solver.nn_approx_impl!r}")


def cadence_key(cfg, frame_host: int) -> tuple:
    """The host decisions of :func:`step` at ``frame_host``: (refine
    against the map, maintain the map) on their cadences; () without a
    map.  A captured step has one graph per key."""
    if not cfg.use_map:
        return ()
    return (frame_host % max(cfg.map.map_every, 1) == 0,
            frame_host % max(cfg.map.maintain_every, 1) == 0)


def resolve_device(device=None) -> torch.device:
    """``device``, or the card when None.  Never falls back to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            "device='cpu' to run it on the CPU")
    return torch.device("cuda")


def init_carry(cfg, device=None) -> OdomCarry:
    """The carry before frame 0, on ``device`` (default: the card)."""
    check_slice(cfg)
    device = resolve_device(device)
    lc = cfg.lidar
    ke = lc.k_edge * lc.target_mult
    kp = lc.k_planar * lc.target_mult

    def zeros(shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    vision = None
    if cfg.use_vision:
        vc = cfg.vision
        pyr = pyr_mod.build_pyramid(zeros((vc.height, vc.width)),
                                    vc.pyr_levels)
        vision = VisionCarry(pyr=pyr, grads=klt_mod.frame_gradients(pyr),
                             tracks=tracks_mod.empty_tracks(vc, device))
    return OdomCarry(
        T_w=se3.identity(device=device),
        delta=zeros(6),
        prev_edges=zeros((ke, 3)),
        prev_edge_mask=zeros((ke,), torch.bool),
        prev_edge_ring=zeros((ke,), torch.int32),
        prev_edge_phase=zeros((ke,)),
        prev_planars=zeros((kp, 3)),
        prev_planar_mask=zeros((kp,), torch.bool),
        prev_planar_phase=zeros((kp,)),
        edge_map=local_map.empty_map(cfg.map.edge_capacity, device),
        planar_map=local_map.empty_map(cfg.map.planar_capacity, device),
        frame_idx=zeros((), torch.int32),
        vision=vision,
        frame_host=0,
    )


def _extract_features_from_ri(ri, cfg):
    """Returns (query_features, target_features) of one range image."""
    cr = curv_mod.compute_curvature(ri, cfg.lidar)
    q = feat_mod.select_features(ri, cr, cfg.lidar)
    t = feat_mod.select_features(ri, cr, cfg.lidar, target=True)
    return q, t


def _masked(pts, mask):
    return torch.where(mask[:, None], pts, 0.0)


def _limit_norm(v: torch.Tensor, limit: float) -> torch.Tensor:
    """The 3-vector ``v`` scaled down to norm ``limit`` where it is longer
    (one correctly rounded division, on either device)."""
    n = torch.clamp(fp.norm3(v), min=1e-9)
    return v * torch.clamp(torch.full_like(n, limit) / n, max=1.0)


def _nanmedian0(a: torch.Tensor) -> torch.Tensor:
    """``jnp.nanmedian(a, axis=0)``: over the non-NaN entries of each
    column, the middle one, or the mean of the two middle ones (0.5 a +
    0.5 b, as JAX's linear quantile); NaN for a column without any.
    ``torch.nanmedian`` returns the lower middle value instead."""
    srt, _ = torch.sort(a, dim=0)  # NaNs sort last
    n = torch.sum(~torch.isnan(a), dim=0).to(a.dtype)
    q = 0.5 * (n - 1.0)
    lo, hi = torch.floor(q), torch.ceil(q)
    w_hi = q - lo
    w_lo = 1.0 - w_hi

    def at(i):
        i = torch.clamp(torch.minimum(i, n - 1.0), min=0.0).long()
        return torch.gather(srt, 0, i[None])[0]

    return at(lo) * w_lo + at(hi) * w_hi


def _visual_front_end(carry, image, cam, T_pred, cfg):
    """Pyramid + forward-backward KLT of the track table, then the
    consensus pre-gate of the depth tracks at the predicted pose.
    Returns (cur_pyr, cur_grads, table, VisData, n_dep, w_scale)."""
    vc, sc = cfg.vision, cfg.solver
    vcar = carry.vision
    cur_pyr = pyr_mod.build_pyramid(image, vc.pyr_levels)
    cur_grads = klt_mod.frame_gradients(cur_pyr)
    tr = klt_mod.track(vcar.pyr, cur_pyr, vcar.grads, cur_grads,
                       vcar.tracks.uv, vcar.tracks.active, vc)
    table = tracks_mod.after_tracking(vcar.tracks, tr.uv, tr.ok)
    tracked = table.active & (carry.frame_idx > 0)
    depth_mask = tracked & vcar.tracks.has_depth
    # A landmark with a wrong interpolated depth reprojects away from where
    # the other tracks agree it should: gate on the deviation from the
    # median residual, not on its size (a wrong prediction moves them all).
    Y_pred = se3.apply(se3.inv(T_pred), vcar.tracks.prev_xyz_velo)
    Xc_pred = se3.apply(cam.T_cam_velo, Y_pred)
    r_pred, _, ok_pred = res.reprojection(Xc_pred, cam.P, table.uv,
                                          depth_mask)
    big = 1e6
    r_m = torch.where((depth_mask & ok_pred)[:, None], r_pred, big)
    med = _nanmedian0(torch.where(r_m < big * 0.5, r_m, torch.nan))
    med = torch.nan_to_num(med)  # no valid tracks: gate around zero
    depth_mask = depth_mask & ok_pred & (
        fp.norm(r_pred - med[None, :]) < sc.vis_pregate_px)
    # Reprojection trust ramp over [lo, hi] surviving depth tracks.
    n_dep = torch.sum(depth_mask, dtype=torch.int32)
    w_scale = torch.clamp(
        fp.div(n_dep.to(torch.float32) - float(sc.vis_depth_lo),
               max(float(sc.vis_depth_hi - sc.vis_depth_lo), 1.0)),
        0.0, 1.0)
    # Per-landmark inverse-variance weight from the depth sensitivity.
    q = fp.div(vcar.tracks.depth_grad, sc.vis_grad_soft)
    w_lm = 1.0 / (1.0 + q * q)
    vis = icp.VisData(
        xyz_prev_velo=vcar.tracks.prev_xyz_velo, obs_uv=table.uv,
        mask=depth_mask, P=cam.P, T_cam_velo=cam.T_cam_velo,
        uv_prev=vcar.tracks.uv,
        mask_nodepth=tracked & ~vcar.tracks.has_depth,
        w_scale=w_scale, w_lm=w_lm)
    return cur_pyr, cur_grads, table, vis, n_dep, w_scale


def _visual_bookkeeping(ri, table, image, cam, cfg) -> tracks_mod.TrackTable:
    """LiDAR depth at the tracked pixels, then corners into free slots."""
    vc = cfg.vision
    dgrid = depth_assoc.build_depth_grid_from_ri(ri, cam, vc,
                                                 az_start=cfg.lidar.az_start)
    dres = depth_assoc.associate(dgrid, table.uv, table.active, cam, vc)
    X_velo = se3.apply(se3.inv(cam.T_cam_velo), dres.xyz_cam)
    table = table._replace(
        prev_xyz_velo=torch.where(dres.ok[:, None], X_velo,
                                  table.prev_xyz_velo),
        has_depth=dres.ok,
        depth_grad=torch.where(dres.ok, dres.grad, 0.0))
    return tracks_mod.replenish(table, corners_mod.detect(image, vc), vc)


def step(carry: OdomCarry, scan: torch.Tensor, scan_mask: torch.Tensor, cfg,
         image: torch.Tensor | None = None,
         cam: cam_mod.Camera | None = None):
    """Process one frame: ``scan`` is a host-pre-binned (R, W, 5) grid and
    ``scan_mask`` its (R, W) validity (``rangeimage.bin_scan_host``), or,
    with ``cfg.prebin_host=False``, the padded raw (N_MAX, 4) points and
    their (N_MAX,) mask (``io.kitti.pad_scan``); with ``cfg.use_vision``,
    ``image`` is the (H, W) float32 grayscale frame and
    ``cam`` its calibration.  All on the carry's device.  Returns
    (new_carry, FrameResult)."""
    check_slice(cfg)
    sc = cfg.solver
    dev = carry.T_w.device
    fi = carry.frame_idx
    if cfg.use_vision and (image is None or cam is None):
        raise ValueError("use_vision=True: step needs image= and cam=")

    # 1-2) Deskew with the predicted motion, then the LiDAR front end.
    with profiling.stage("lidar_front"):
        if cfg.prebin_host:
            ri = ri_mod.range_image_from_grid(
                scan, scan_mask, carry.delta, cfg.lidar,
                enabled=cfg.use_deskew)
        else:
            pts3, phase = deskew_mod.deskew(
                scan[:, :3], carry.delta, az_start=cfg.lidar.az_start,
                enabled=cfg.use_deskew)
            ri = ri_mod.build_range_image(pts3, scan_mask, phase, cfg.lidar)
        feats, tfeats = _extract_features_from_ri(ri, cfg)
        T_pred = se3.exp(carry.delta)
        vis = None
        n_dep = torch.zeros((), dtype=torch.int32, device=dev)
        w_scale = torch.ones((), device=dev)

    # 2v) Visual front end: pyramid, KLT, reprojection data.
    if cfg.use_vision:
        with profiling.stage("vision_front"):
            cur_pyr, cur_grads, table, vis, n_dep, w_scale = _visual_front_end(
                carry, image, cam, T_pred, cfg)

    # 3) Scan-to-scan solve vs the previous features, with one global
    # candidate search per target set shared by both solves (dense engine).
    with profiling.stage("solve"):
        edge_targets = icp.make_targets(carry.prev_edges, carry.prev_edge_mask,
                                        payload=carry.prev_edge_ring[:, None])
        planar_targets = icp.make_targets(carry.prev_planars,
                                          carry.prev_planar_mask)
        if sc.nn_engine == "dense" and sc.reuse_candidates:
            e_cands = icp.build_candidates(edge_targets, feats.edges,
                                           feats.edge_mask, T_pred, sc)
            p_cands = icp.build_candidates(planar_targets, feats.planars,
                                           feats.planar_mask, T_pred, sc)
        else:
            e_cands = p_cands = None
        # The motion prior applies once a velocity estimate exists.
        prior_scale = (fi >= 2).to(torch.float32)

        def fix(pts, phase, mask, old, new):
            return _masked(deskew_mod.redeskew(pts, phase, old, new), mask)

        def fix_feats(f, old, new):
            return f._replace(
                edges=fix(f.edges, f.edge_phase, f.edge_mask, old, new),
                planars=fix(f.planars, f.planar_phase, f.planar_mask, old,
                            new))

        if cfg.use_deskew and sc.ct_sweep:
            # Continuous time: one 12-DoF solve of the pose and the scan's own
            # sweep motion xi2 replaces the redeskew fixed point.
            T_rel, xi2, diag = icp.solve_scan_to_scan_ct(
                feats.edges, feats.edge_phase, feats.edge_mask, feats.planars,
                feats.planar_phase, feats.planar_mask, edge_targets,
                planar_targets, T_pred, carry.delta, sc, vis=vis,
                edge_cands=e_cands, planar_cands=p_cands, prior_T=T_pred,
                prior_scale=prior_scale)
            # The sweep motion cannot leave the inter-frame motion by more than
            # physical acceleration allows: clamp the deviation, so that a
            # weakly observed xi2 cannot corrupt the stored features or map.
            base = se3.log(T_rel)
            dev2 = xi2 - base
            dev2 = torch.cat([_limit_norm(dev2[:3], sc.max_accel_trans),
                              _limit_norm(dev2[3:], sc.max_accel_rot)])
            # Frames 0/1 have no correction reference: keep the identity
            # re-correction so both scans carry matching distortion.
            xi2 = torch.where(fi >= 2, base + dev2, carry.delta)
            feats = fix_feats(feats, carry.delta, xi2)
            tfeats = fix_feats(tfeats, carry.delta, xi2)
            deskew_ref = None  # the features carry their final correction
        else:
            T_rel, diag = icp.solve_scan_to_scan(
                feats.edges, feats.edge_mask, feats.planars, feats.planar_mask,
                edge_targets, planar_targets, T_pred, sc, vis=vis,
                edge_cands=e_cands, planar_cands=p_cands, prior_T=T_pred,
                prior_scale=prior_scale)
            deskew_ref = carry.delta
        if cfg.use_deskew and not sc.ct_sweep:
            # Deskew/solve fixed point: re-correct the features with the solved
            # motion and solve again.  Frames 0/1 keep identity re-correction.
            delta1 = torch.where(fi >= 2, se3.log(T_rel), carry.delta)
            feats = fix_feats(feats, carry.delta, delta1)
            tfeats = fix_feats(tfeats, carry.delta, delta1)
            if sc.deskew_exact_lag and sc.exact_lag_targets:
                # Exact one-frame-lag deskew of the targets: scan i-1's sweep
                # spans poses i-1 -> i, so its true sweep motion is the delta
                # solved now, not the one it was stored with (the identity
                # under constant velocity).  The stored correction reference is
                # carry.delta, the previous frame's realized motion.
                edge_targets = icp.make_targets(
                    fix(carry.prev_edges, carry.prev_edge_phase,
                        carry.prev_edge_mask, carry.delta, delta1),
                    carry.prev_edge_mask,
                    payload=carry.prev_edge_ring[:, None])
                planar_targets = icp.make_targets(
                    fix(carry.prev_planars, carry.prev_planar_phase,
                        carry.prev_planar_mask, carry.delta, delta1),
                    carry.prev_planar_mask)

                def fix_cache(cands):
                    # The cache gathered target coordinates before this
                    # redeskew: re-correct them, with the phase recovered from
                    # the azimuth (as it was assigned, up to the sub-degree
                    # shift of the correction itself).
                    if cands is None:
                        return None
                    flat = cands.pts.reshape(-1, 3)
                    ph = deskew_mod.azimuth_phase(flat,
                                                  az_start=cfg.lidar.az_start)
                    fixed = deskew_mod.redeskew(flat, ph, carry.delta, delta1)
                    return cands._replace(pts=fixed.reshape(cands.pts.shape))

                e_cands, p_cands = fix_cache(e_cands), fix_cache(p_cands)
            T_rel, diag = icp.solve_scan_to_scan(
                feats.edges, feats.edge_mask, feats.planars, feats.planar_mask,
                edge_targets, planar_targets, T_rel, sc, vis=vis,
                iters=sc.icp_iters_redeskew, edge_cands=e_cands,
                planar_cands=p_cands, prior_T=T_pred, prior_scale=prior_scale)
            deskew_ref = delta1

        # Plausibility gate: a motion far from the constant-velocity prediction
        # means wrong correspondences; keep the prediction instead.
        dev_xi = se3.log(se3.compose(se3.inv(se3.exp(carry.delta)), T_rel))
        nt = fp.norm3(dev_xi[:3])
        nr = fp.norm3(dev_xi[3:])
        implausible = ((nt > sc.max_accel_trans) | (nr > sc.max_accel_rot)) & (
            fi >= 2)
        prior_active = ((nt > sc.prior_deadzone_trans)
                        | (nr > sc.prior_deadzone_rot)) & (prior_scale > 0)
        T_rel = torch.where(implausible, se3.exp(carry.delta), T_rel)
        T_w = se3.compose(carry.T_w, T_rel)

    # 4) Scan-to-map refinement against the local map.
    with profiling.stage("map_refine"):
        zero_i = torch.zeros((), dtype=torch.int32, device=dev)
        map_applied = torch.zeros((), dtype=torch.bool, device=dev)
        lm_accept_map = zero_i
        refine, maintain = cadence_key(cfg, carry.frame_host) or (False, False)
        if cfg.use_map:
            e_targets = icp.make_targets(carry.edge_map.pts,
                                         carry.edge_map.mask)
            p_targets = icp.make_targets(carry.planar_map.pts,
                                         carry.planar_map.mask)
            has_map = (torch.sum(carry.edge_map.mask)
                       + torch.sum(carry.planar_map.mask)) > 100
            if refine:
                T_map, diag_m = icp.solve_scan_to_map(
                    feats.edges, feats.edge_mask, feats.planars,
                    feats.planar_mask, e_targets, p_targets, T_w, sc,
                    prior_T=T_w, prior_scale=prior_scale)
            else:  # refinement cadence: a skipped frame keeps its pose
                T_map, diag_m = T_w, icp.SolveDiag(
                    n_edge=zero_i, n_planar=zero_i,
                    cost=torch.zeros((), device=dev),
                    degenerate=torch.ones((), dtype=torch.bool, device=dev),
                    lm_accept=zero_i)
            corr = se3.log(se3.compose(se3.inv(T_w), T_map))
            map_ok = ((fp.norm3(corr[:3]) < sc.max_map_corr_trans)
                      & (fp.norm3(corr[3:]) < sc.max_map_corr_rot))
            map_applied = has_map & ~diag_m.degenerate & map_ok
            lm_accept_map = diag_m.lm_accept
            T_w = torch.where(map_applied, T_map, T_w)

    # 5) Velocity from the realized motion; the first frame keeps zero.
    with profiling.stage("map_update"):
        delta_new = se3.log(se3.compose(se3.inv(carry.T_w), T_w))
        delta_new = torch.where(fi == 0, 0.0, delta_new)

        # 6) Re-correct the targets with the solved motion (the
        # continuous-time path has corrected them already).
        if cfg.use_deskew and deskew_ref is not None:
            edges_fix = fix(tfeats.edges, tfeats.edge_phase, tfeats.edge_mask,
                            deskew_ref, delta_new)
            planars_fix = fix(tfeats.planars, tfeats.planar_phase,
                              tfeats.planar_mask, deskew_ref, delta_new)
        else:
            edges_fix, planars_fix = tfeats.edges, tfeats.planars

        # 7) Map update: insert world-frame features, maintain on a cadence.
        edge_map, planar_map = carry.edge_map, carry.planar_map
        if cfg.use_map:
            if cfg.use_deskew and not sc.ct_sweep and sc.deskew_exact_lag:
                # Exact-lag insert: this frame's realized motion pins the
                # previous scan's sweep motion, so insert the previous scan's
                # features, re-corrected with it, at the previous pose: one
                # frame late, without the map accumulating O(accel) distortion.
                exact = torch.where(fi == 0, carry.delta, delta_new)
                ins_T = carry.T_w
                ins_edges = deskew_mod.redeskew(
                    carry.prev_edges, carry.prev_edge_phase, carry.delta,
                    exact)
                ins_planars = deskew_mod.redeskew(
                    carry.prev_planars, carry.prev_planar_phase, carry.delta,
                    exact)
                ins_edge_mask = carry.prev_edge_mask
                ins_planar_mask = carry.prev_planar_mask
            else:
                ins_T, ins_edges, ins_planars = T_w, edges_fix, planars_fix
                ins_edge_mask, ins_planar_mask = (tfeats.edge_mask,
                                                  tfeats.planar_mask)
            edge_map = local_map.insert(edge_map, se3.apply(ins_T, ins_edges),
                                        ins_edge_mask)
            planar_map = local_map.insert(planar_map,
                                          se3.apply(ins_T, ins_planars),
                                          ins_planar_mask)
            if maintain:
                center = T_w[:3, 3]
                edge_map = local_map.maintain(edge_map, center,
                                              cfg.map.voxel_edge,
                                              cfg.map.crop_radius)
                planar_map = local_map.maintain(planar_map, center,
                                                cfg.map.voxel_planar,
                                                cfg.map.crop_radius)

    # 8) Visual bookkeeping for the next frame.
    new_vision = carry.vision
    if cfg.use_vision:
        with profiling.stage("vision_book"):
            new_vision = VisionCarry(
                pyr=cur_pyr, grads=cur_grads,
                tracks=_visual_bookkeeping(ri, table, image, cam, cfg))

    new_carry = OdomCarry(
        T_w=T_w,
        delta=delta_new,
        prev_edges=edges_fix,
        prev_edge_mask=tfeats.edge_mask,
        prev_edge_ring=tfeats.edge_ring,
        prev_edge_phase=tfeats.edge_phase,
        prev_planars=planars_fix,
        prev_planar_mask=tfeats.planar_mask,
        prev_planar_phase=tfeats.planar_phase,
        edge_map=edge_map,
        planar_map=planar_map,
        frame_idx=fi + 1,
        vision=new_vision,
        frame_host=carry.frame_host + 1,
    )
    result = FrameResult(
        T_w=T_w, n_edge=diag.n_edge, n_planar=diag.n_planar,
        cost=diag.cost, degenerate=diag.degenerate,
        lm_accept=diag.lm_accept, lm_accept_map=lm_accept_map,
        implausible=implausible, map_applied=map_applied,
        prior_active=prior_active, n_depth=n_dep, vis_w_scale=w_scale,
    )
    return new_carry, result


def _stack_results(outs) -> dict:
    """Per-frame results -> {field: numpy array over the frames}."""
    stacked = stack_results(outs)
    return {k: getattr(stacked, k).cpu().numpy() for k in FrameResult._fields}


def stack_results(outs) -> FrameResult:
    """Per-frame results -> one FrameResult, each field stacked over the
    frames on its device."""
    return FrameResult(*(torch.stack([getattr(o, k) for o in outs])
                         for k in FrameResult._fields))


def jit_step(carry: OdomCarry, scan: torch.Tensor, scan_mask: torch.Tensor,
             cfg, image: torch.Tensor | None = None,
             cam: cam_mod.Camera | None = None):
    """:func:`step` as one device program (the reference's ``jit_step``):
    on a CUDA carry, one replay of a CUDA graph of the step
    (``pipeline/graphs.py``: one graph per cadence key, captured at first
    need, a failed capture raises); on the CPU, :func:`step` itself.

    On the card the returned carry is the graph's static carry, donated as
    the reference donates its carry: the next call of this configuration
    overwrites it (pass it back in, or clone it to keep it).  The
    FrameResult is a copy of its own."""
    if carry.T_w.device.type != "cuda":
        return step(carry, scan, scan_mask, cfg, image=image, cam=cam)

    def fn(c, s, m, im, cm):
        return step(c, s, m, cfg, image=im, cam=cm)

    inputs = (scan, scan_mask, image, cam)
    return graphs.runner("odometry.step", cfg, fn, carry, inputs,
                         lambda fh: cadence_key(cfg, fh))(carry, *inputs)


def run_scan(carry: OdomCarry, scans: torch.Tensor, scan_masks: torch.Tensor,
             cfg, images: torch.Tensor | None = None,
             cam: cam_mod.Camera | None = None):
    """Device-resident entry (the reference's ``run_scan``): (F, ...)
    frames already on the carry's device, one :func:`jit_step` each (on
    the card one graph replay).  Returns (final carry, FrameResult with
    each field stacked over F), all on the device; ``carry`` itself is not
    changed."""
    outs = []
    for f in range(scans.shape[0]):
        carry, out = jit_step(carry, scans[f], scan_masks[f], cfg,
                              image=None if images is None else images[f],
                              cam=cam)
        outs.append(out)
    if not outs:
        raise ValueError("run_scan: no frames")
    if carry.T_w.device.type == "cuda":
        carry = graphs.clone(carry)
    return carry, stack_results(outs)


def run_sequence(frames, cfg, carry: OdomCarry | None = None, device=None,
                 cam: cam_mod.Camera | None = None, checkpoint_path=None,
                 checkpoint_every: int = 0, resume: bool = False):
    """Stream numpy frames through :func:`jit_step` (on the card one
    CUDA-graph replay per frame): (scan, mask) pairs, or
    (scan, mask, image) triples with ``cfg.use_vision`` and its ``cam``;
    ``scan`` / ``mask`` are a pre-binned grid or, with
    ``cfg.prebin_host=False``, a padded raw scan.  ``frames`` may be any
    iterable, a generator included.

    Without a ``carry`` it starts from :func:`init_carry` on ``device``
    (default: the card).  Per-frame results stay on the device until the
    end, so the loop never waits for it, except at a checkpoint: with
    ``checkpoint_path`` and ``checkpoint_every`` the carry and the
    trajectory so far come to the host every N frames and are dumped
    (``pipeline.checkpoint``).  ``resume=True`` reloads both and skips the
    frames already processed, so a resumed run returns the full
    trajectory, identical to an uninterrupted one.  Returns (poses
    (F,4,4) numpy, diagnostics dict of numpy arrays, final carry).
    """
    from velo_tpu_torch.pipeline import checkpoint as ckpt

    if carry is None:
        carry = init_carry(cfg, device)
    dev = carry.T_w.device
    if cfg.use_vision:
        if cam is None:
            raise ValueError("use_vision=True: run_sequence needs cam=")
        cam = cam.to(dev)

    def put(x, dtype):
        return torch.as_tensor(np.asarray(x, dtype)).to(dev)

    skip = 0
    done = None  # the history that is on the host already
    if resume:
        if not (checkpoint_path and os.path.exists(checkpoint_path)):
            raise FileNotFoundError(
                f"--resume requires an existing checkpoint: {checkpoint_path}")
        carry = ckpt.load_carry(checkpoint_path, carry)
        skip = carry.frame_host
        hist = ckpt.load_history(checkpoint_path)
        if "poses" not in hist:
            raise ValueError(
                f"checkpoint {checkpoint_path} predates trajectory history; "
                "rerun from scratch (resume would return a truncated file)")
        done = {"T_w": hist["poses"]}
        for k in FrameResult._fields[1:]:
            # A checkpoint written before a diagnostic existed replays as
            # the field's scan-time default for those frames.
            done[k] = (hist[k] if k in hist else np.asarray(
                [_RESULT_DEFAULTS[k]] * len(hist["poses"])))

    outs = []  # the results that are still on the device

    def flush():
        """Bring ``outs`` to the host, behind the history there."""
        nonlocal done
        if outs:
            new = _stack_results(outs)
            outs.clear()
            done = new if done is None else {
                k: np.concatenate([done[k].astype(new[k].dtype), new[k]])
                for k in new}
        return done

    for i, frame in enumerate(frames):
        if i < skip:
            continue
        image = put(frame[2], np.float32) if cfg.use_vision else None
        carry, out = jit_step(carry, put(frame[0], np.float32),
                              put(frame[1], bool), cfg, image=image, cam=cam)
        outs.append(out)
        if checkpoint_path and checkpoint_every and (
                (i + 1) % checkpoint_every == 0):
            hist = dict(flush())
            hist["poses"] = hist.pop("T_w")
            ckpt.save_carry(checkpoint_path, carry, frame_idx=i + 1,
                            history=hist)
    if flush() is None:
        raise ValueError("run_sequence: no frames")
    stacked = dict(done)
    poses = stacked.pop("T_w")
    if carry.T_w.device.type == "cuda":
        carry = graphs.clone(carry)
    return poses, stacked, carry


def run_sequence_host(frames, cfg, carry: OdomCarry | None = None, cam=None,
                      checkpoint_path=None, checkpoint_every: int = 0,
                      resume: bool = False, device=None):
    """:func:`run_sequence` with the reference's signature and return
    value: (poses (F,4,4) numpy, diagnostics dict of numpy arrays)."""
    poses, diags, _ = run_sequence(
        frames, cfg, carry=carry, device=device, cam=cam,
        checkpoint_path=checkpoint_path, checkpoint_every=checkpoint_every,
        resume=resume)
    return poses, diags


def carry_from_jax_numpy(tree, device=None) -> OdomCarry:
    """The port's carry from a reference ``OdomCarry`` whose leaves are
    numpy arrays (``jax.tree.map(np.asarray, carry)``), on ``device``
    (default: the card), ``VisionCarry`` included."""
    device = resolve_device(device)

    def t(x):
        return torch.tensor(np.asarray(x), device=device)

    def lmap(m):
        return local_map.LocalMap(pts=t(m.pts), mask=t(m.mask),
                                  cursor=t(m.cursor))

    vision = None
    if getattr(tree, "vision", None) is not None:
        v = tree.vision
        vision = VisionCarry(
            pyr=tuple(t(x) for x in v.pyr),
            grads=tuple((t(gx), t(gy)) for gx, gy in v.grads),
            tracks=tracks_mod.TrackTable(*(t(x) for x in v.tracks)))
    return OdomCarry(
        **{f: t(getattr(tree, f)) for f in OdomCarry._fields
           if f not in ("edge_map", "planar_map", "vision", "frame_host")},
        edge_map=lmap(tree.edge_map), planar_map=lmap(tree.planar_map),
        vision=vision, frame_host=int(np.asarray(tree.frame_idx)),
    )


def carry_to_numpy(carry: OdomCarry) -> OdomCarry:
    """The carry with numpy leaves, field for field as the reference's."""
    def n(x):
        return x.detach().cpu().numpy()

    def lmap(m):
        return local_map.LocalMap(*(n(x) for x in m))

    vision = None
    if carry.vision is not None:
        v = carry.vision
        vision = VisionCarry(
            pyr=tuple(n(x) for x in v.pyr),
            grads=tuple((n(gx), n(gy)) for gx, gy in v.grads),
            tracks=tracks_mod.TrackTable(*(n(x) for x in v.tracks)))
    return carry._replace(
        **{f: n(getattr(carry, f)) for f in OdomCarry._fields
           if f not in ("edge_map", "planar_map", "vision", "frame_host")},
        edge_map=lmap(carry.edge_map), planar_map=lmap(carry.planar_map),
        vision=vision)


def velo_to_cam_trajectory(poses_velo: np.ndarray,
                           T_cam_velo: np.ndarray) -> np.ndarray:
    """World-from-velo poses -> KITTI cam0 convention (first pose identity)."""
    T_cv = np.asarray(T_cam_velo, np.float64)
    T_vc = np.linalg.inv(T_cv)
    poses_cam = np.einsum("ij,fjk,kl->fil", T_cv,
                          np.asarray(poses_velo, np.float64), T_vc)
    return np.einsum("ij,fjk->fik", np.linalg.inv(poses_cam[0]), poses_cam)
