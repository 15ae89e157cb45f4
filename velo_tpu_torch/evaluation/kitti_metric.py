"""Official KITTI odometry drift metric, faithful numpy port (SURVEY.md C15).

Implements the devkit algorithm exactly (SURVEY.md §3.4): for every start
frame (every ``step`` frames) and every segment length in {100..800} m (found
by cumulative ground-truth arc length), compare the relative GT and estimated
motions and accumulate translational error (fraction of segment length) and
rotational error (rad per meter).  Reported as %/100m and deg/100m (and deg/m),
averaged over all (start, length) segments — the benchmark's north-star metric.

Host-side numpy on purpose: this is an eval script, not a kernel.  The
port's own copy of ``velo_tpu/evaluation/kitti_metric.py``; the tests hold
the two equal.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

SEGMENT_LENGTHS = (100.0, 200.0, 300.0, 400.0, 500.0, 600.0, 700.0, 800.0)
FRAME_STEP = 10


def trajectory_distances(poses: np.ndarray) -> np.ndarray:
    """Cumulative arc length (F,) along a (F,4,4) trajectory."""
    t = poses[:, :3, 3]
    seg = np.linalg.norm(np.diff(t, axis=0), axis=1)
    return np.concatenate([[0.0], np.cumsum(seg)])


def _last_frame_from_segment_length(dist: np.ndarray, first: int, length: float) -> int:
    # devkit: first frame whose cumulative distance exceeds dist[first] + length
    target = dist[first] + length
    idx = np.searchsorted(dist, target, side="left")
    return int(idx) if idx < len(dist) else -1


def rotation_error(pose_error: np.ndarray) -> float:
    """Rotation angle of a 4x4 error transform (devkit formula)."""
    a, b, c = pose_error[0, 0], pose_error[1, 1], pose_error[2, 2]
    d = 0.5 * (a + b + c - 1.0)
    return float(np.arccos(np.clip(d, -1.0, 1.0)))

def translation_error(pose_error: np.ndarray) -> float:
    return float(np.linalg.norm(pose_error[:3, 3]))


@dataclass
class KittiErrors:
    t_err_pct: float  # translational drift, % per 100 m (i.e. fraction * 100)
    r_err_deg_per_100m: float
    r_err_deg_per_m: float
    n_segments: int
    per_length: dict  # length -> (t_err_pct, r_err_deg_per_100m, count)


def evaluate_trajectory(
    est: np.ndarray,
    gt: np.ndarray,
    lengths: Sequence[float] = SEGMENT_LENGTHS,
    step: int = FRAME_STEP,
) -> KittiErrors:
    """Compute KITTI drift for an estimated (F,4,4) trajectory vs ground truth."""
    est = np.asarray(est, dtype=np.float64)
    gt = np.asarray(gt, dtype=np.float64)
    assert est.shape == gt.shape, (est.shape, gt.shape)
    dist = trajectory_distances(gt)

    t_errs, r_errs, seg_lens = [], [], []
    for first in range(0, len(gt), step):
        for length in lengths:
            last = _last_frame_from_segment_length(dist, first, length)
            if last == -1:
                continue
            delta_gt = np.linalg.inv(gt[first]) @ gt[last]
            delta_est = np.linalg.inv(est[first]) @ est[last]
            err = np.linalg.inv(delta_est) @ delta_gt
            t_errs.append(translation_error(err) / length)
            r_errs.append(rotation_error(err) / length)
            seg_lens.append(length)

    if not t_errs:
        return KittiErrors(float("nan"), float("nan"), float("nan"), 0, {})

    t_arr, r_arr, l_arr = map(np.asarray, (t_errs, r_errs, seg_lens))
    per_length = {}
    for length in lengths:
        m = l_arr == length
        if m.any():
            per_length[length] = (
                float(t_arr[m].mean() * 100.0),
                float(np.degrees(r_arr[m].mean()) * 100.0),
                int(m.sum()),
            )
    return KittiErrors(
        t_err_pct=float(t_arr.mean() * 100.0),
        r_err_deg_per_100m=float(np.degrees(r_arr.mean()) * 100.0),
        r_err_deg_per_m=float(np.degrees(r_arr.mean())),
        n_segments=len(t_errs),
        per_length=per_length,
    )


def ate_rmse(est: np.ndarray, gt: np.ndarray) -> float:
    """Absolute trajectory error RMSE (no alignment) — a secondary diagnostic."""
    d = np.asarray(est)[:, :3, 3] - np.asarray(gt)[:, :3, 3]
    return float(np.sqrt((d**2).sum(axis=1).mean()))
