"""Trajectory / drift plots (SURVEY.md C15, L5 "trajectory plots").

The reference evaluates with the KITTI devkit, whose plot set is the XY
bird's-eye path plus per-segment-length error curves; this reproduces both
from the same ``evaluate_trajectory`` pass, host-side with matplotlib (an
eval artifact, not a kernel).
"""
from __future__ import annotations

import os

import numpy as np


def plot_trajectory(out_dir: str, name: str, est_cam: np.ndarray,
                    gt_cam: np.ndarray | None = None) -> list[str]:
    """Write <name>_path.png (+ <name>_errors.png with GT). Returns paths."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from velo_tpu_torch.evaluation import kitti_metric

    os.makedirs(out_dir, exist_ok=True)
    written = []

    # KITTI cam frame: x right, z forward -> bird's eye = (x, z).
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.plot(est_cam[:, 0, 3], est_cam[:, 2, 3], "b-", label="estimate")
    if gt_cam is not None:
        ax.plot(gt_cam[:, 0, 3], gt_cam[:, 2, 3], "r--", label="ground truth")
    ax.plot([est_cam[0, 0, 3]], [est_cam[0, 2, 3]], "ks", label="start")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_aspect("equal")
    ax.legend()
    ax.set_title(f"{name}: trajectory")
    p = os.path.join(out_dir, f"{name}_path.png")
    fig.savefig(p, dpi=120, bbox_inches="tight")
    plt.close(fig)
    written.append(p)

    if gt_cam is None:
        return written

    lengths = np.asarray(kitti_metric.SEGMENT_LENGTHS, float)
    t_per_len, r_per_len = [], []
    for L in lengths:
        e = kitti_metric.evaluate_trajectory(est_cam, gt_cam,
                                             lengths=(float(L),))
        t_per_len.append(e.t_err_pct if e.n_segments else np.nan)
        r_per_len.append(e.r_err_deg_per_100m if e.n_segments else np.nan)

    fig, axes = plt.subplots(1, 2, figsize=(10, 4))
    axes[0].plot(lengths, t_per_len, "bs-")
    axes[0].set_xlabel("segment length [m]")
    axes[0].set_ylabel("translation error [%]")
    axes[1].plot(lengths, r_per_len, "bs-")
    axes[1].set_xlabel("segment length [m]")
    axes[1].set_ylabel("rotation error [deg/100m]")
    fig.suptitle(f"{name}: drift by segment length")
    p = os.path.join(out_dir, f"{name}_errors.png")
    fig.savefig(p, dpi=120, bbox_inches="tight")
    plt.close(fig)
    written.append(p)
    return written
