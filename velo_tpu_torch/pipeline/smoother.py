"""Non-causal trajectory smoother: windowed scan-to-window-map refinement
(port of ``velo_tpu/pipeline/smoother.py``).

The forward odometry is strictly causal: each pose sees only past scans.
For a recorded sequence evaluated offline a second, non-causal pass is
legitimate.  Given forward poses, every frame's refinement is independent:
frame i re-solves scan-to-map against a window map built from the features
of frames j in [i-W, i+W] without i, at their current pose estimates.  That
is a Jacobi sweep: all frames solve against the same pose snapshot, then
the poses update together; ``passes`` sweeps diffuse constraints about W
frames per pass in both time directions.  Features are deskewed with the
realized per-frame motion (the log of the forward relative pose) instead
of the forward pass's constant-velocity prediction.

Each frame's solve searches its candidates once per target set through
``dist_topk``, against (2W+1) * K window targets: two launches per frame
and pass on the card.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from velo_tpu_torch import fp
from velo_tpu_torch.geom import se3
from velo_tpu_torch.lidar import deskew as deskew_mod
from velo_tpu_torch.lidar import rangeimage as ri_mod
from velo_tpu_torch.pipeline import odometry
from velo_tpu_torch.solve import icp


class FrameFeatures(NamedTuple):
    """Per-frame feature stacks (leading F dim), scan-local coordinates."""

    q_edges: torch.Tensor  # (F, Ke, 3) sparse query edges
    q_edge_mask: torch.Tensor
    q_planars: torch.Tensor  # (F, Kp, 3)
    q_planar_mask: torch.Tensor
    t_edges: torch.Tensor  # (F, Kte, 3) dense map-target edges
    t_edge_mask: torch.Tensor
    t_planars: torch.Tensor  # (F, Ktp, 3)
    t_planar_mask: torch.Tensor


def realized_deltas(poses: torch.Tensor) -> torch.Tensor:
    """(F, 6) per-frame motion xi_i = log(T_{i-1}^-1 T_i); frame 0 borrows
    frame 1's motion (the scan was taken moving; the forward pass had no
    estimate yet, but the smoother does)."""
    xi = se3.log(se3.compose(se3.inv(poses[:-1]), poses[1:]))  # (F-1, 6)
    return torch.cat([xi[:1], xi], dim=0)


def collect_features(scans: torch.Tensor, masks: torch.Tensor,
                     poses: torch.Tensor, cfg) -> FrameFeatures:
    """Re-run the LiDAR front end per frame, deskewed with realized motion.
    ``scans`` / ``masks`` are the (F, ...) stacks the forward pass consumed:
    pre-binned grids with ``cfg.prebin_host``, else padded raw scans."""
    deltas = realized_deltas(poses)
    per_frame = []
    for scan, mask, delta in zip(scans, masks, deltas):
        if cfg.prebin_host:
            ri = ri_mod.range_image_from_grid(scan, mask, delta, cfg.lidar,
                                              enabled=cfg.use_deskew)
        else:
            pts3, phase = deskew_mod.deskew(
                scan[:, :3], delta, az_start=cfg.lidar.az_start,
                enabled=cfg.use_deskew)
            ri = ri_mod.build_range_image(pts3, mask, phase, cfg.lidar)
        q, t = odometry._extract_features_from_ri(ri, cfg)
        per_frame.append((q.edges, q.edge_mask, q.planars, q.planar_mask,
                          t.edges, t.edge_mask, t.planars, t.planar_mask))
    return FrameFeatures(*(torch.stack(x) for x in zip(*per_frame)))


def _window_targets(stack_p, mask_p, poses_p, i: int, w: int):
    """World-frame window cloud for frame i from padded (F+2w, K, 3) stacks;
    the centre frame (j == i) is masked out, so a frame never matches
    itself."""
    pts = stack_p[i:i + 2 * w + 1]
    msk = mask_p[i:i + 2 * w + 1]
    world = se3.apply(poses_p[i:i + 2 * w + 1], pts)  # (2w+1, K, 3)
    not_self = torch.arange(2 * w + 1, device=pts.device) != w
    msk = msk & not_self[:, None]
    K = pts.shape[1]
    return world.reshape((2 * w + 1) * K, 3), msk.reshape((2 * w + 1) * K)


def refine_poses(poses: torch.Tensor, feats: FrameFeatures, cfg,
                 window: int = 8, passes: int = 2, iters: int | None = None,
                 alpha: float = 0.7) -> torch.Tensor:
    """Damped-Jacobi smoothing sweeps; returns refined (F, 4, 4) poses.

    Reuses the forward pipeline's scan-to-map solve and plausibility gates:
    a refinement that moves a pose farther than ``max_map_corr_*`` or comes
    from a degenerate system is rejected for that frame and pass.
    ``alpha`` under-relaxes each frame's correction (T_i exp(alpha xi)):
    undamped parallel updates oscillate, because every frame solves
    against a snapshot that its neighbours are abandoning at the same time.
    """
    sc = cfg.solver
    F = poses.shape[0]
    w = window

    def pad_f(x):
        pad = torch.zeros((w,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        return torch.cat([pad, x, pad], dim=0)

    te_p, tp_p = pad_f(feats.t_edges), pad_f(feats.t_planars)
    tem_p, tpm_p = pad_f(feats.t_edge_mask), pad_f(feats.t_planar_mask)

    def one_pass(poses):
        eye = se3.identity(poses.dtype, poses.device).expand(w, 4, 4)
        poses_p = torch.cat([eye, poses, eye], dim=0)

        def solve_i(i):
            e_pts, e_msk = _window_targets(te_p, tem_p, poses_p, i, w)
            p_pts, p_msk = _window_targets(tp_p, tpm_p, poses_p, i, w)
            T_i = poses[i]
            T_new, diag = icp.solve_scan_to_map(
                feats.q_edges[i], feats.q_edge_mask[i],
                feats.q_planars[i], feats.q_planar_mask[i],
                icp.make_targets(e_pts, e_msk),
                icp.make_targets(p_pts, p_msk), T_i, sc, iters=iters)
            corr = se3.log(se3.compose(se3.inv(T_i), T_new))
            ok = ((fp.norm3(corr[:3]) < sc.max_map_corr_trans)
                  & (fp.norm3(corr[3:]) < sc.max_map_corr_rot)
                  & ~diag.degenerate)
            T_damped = se3.compose(T_i, se3.exp(alpha * corr))
            return torch.where(ok, T_damped, T_i)

        # Every frame solves against the same snapshot `poses`.
        new = torch.stack([solve_i(i) for i in range(F)])
        # The window solves only constrain relative geometry; pin the
        # global gauge by rebasing so that frame 0 keeps its forward pose.
        fix = se3.compose(poses[0], se3.inv(new[0]))
        return se3.compose(fix[None], new)

    for _ in range(passes):
        poses = one_pass(poses)
    return poses


def smooth_trajectory(scans, masks, poses, cfg, window: int = 8,
                      passes: int = 2, iters: int | None = None,
                      alpha: float = 0.7, device=None) -> np.ndarray:
    """Per pass, re-collect the features, then sweep once; returns the
    refined (F, 4, 4) poses as numpy.

    Features are re-collected every pass because the deskew uses the
    realized per-frame deltas, which change as the poses are refined: a
    stale error in the trajectory would otherwise be frozen into the
    feature clouds as deskew distortion.

    ``scans`` / ``masks`` are the (F, ...) numpy stacks the forward pass
    consumed (raw padded points, or pre-binned grids with
    ``cfg.prebin_host``), ``poses`` the forward (F, 4, 4) world-from-velo
    trajectory.  Everything is held on ``device`` (default: the card).
    """
    dev = odometry.resolve_device(device)
    # Feature collection never needs the vision carry: force the LiDAR-only
    # front end, so that the same entry serves fused forward runs too.
    lcfg = dataclasses.replace(cfg, use_vision=False)
    odometry.check_slice(lcfg)
    scans = torch.tensor(np.asarray(scans, np.float32), device=dev)
    masks = torch.tensor(np.asarray(masks, bool), device=dev)
    poses = torch.tensor(np.asarray(poses, np.float32), device=dev)
    for _ in range(passes):
        feats = collect_features(scans, masks, poses, lcfg)
        poses = refine_poses(poses, feats, lcfg, window=window, passes=1,
                             iters=iters, alpha=alpha)
    return poses.cpu().numpy()
