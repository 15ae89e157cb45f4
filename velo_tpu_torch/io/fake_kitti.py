"""Export a synthetic drive as a KITTI odometry sequence directory.

Writes the on-disk layout that :class:`velo_tpu_torch.io.kitti.KittiSequence`
reads: ``sequences/<seq>/velodyne/XXXXXX.bin`` (float32 N x 4),
``image_0/XXXXXX.png`` (8-bit grayscale), ``calib.txt`` (P0-P3 + Tr),
``times.txt`` and ``poses/<seq>.txt`` ground truth, so the command line's
``--kitti-root`` path (hdl64e ring table, sweep start at the rear, calib
parse, image read-ahead) runs end to end without real data.

Usage: python -m velo_tpu_torch.io.fake_kitti --out DIR --frames 8
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from velo_tpu_torch.io import fixtures, kitti, png
from velo_tpu_torch.lidar.rangeimage import hdl64e_beam_elevations


def export(out: str, seq: str = "00", frames: int = 8, rings: int = 64,
           azimuth: int = 2048, height: int = 192, width: int = 640,
           seed: int = 0) -> str:
    """Simulate ``frames`` frames and write them under ``out``; returns the
    sequence directory."""
    # Real HDL-64E conventions: non-uniform two-block beam table, sweep
    # start near the rear (~pi), as the --kitti-root path assumes.
    fx = fixtures.make_fixture(
        n_frames=frames, n_rings=rings, n_azimuth=azimuth, height=height,
        width=width, with_images=True, seed=seed,
        beam_elev=hdl64e_beam_elevations(rings), az_start=float(np.pi))
    seq_dir = os.path.join(out, "sequences", seq)
    velo_dir = os.path.join(seq_dir, "velodyne")
    img_dir = os.path.join(seq_dir, "image_0")
    pose_dir = os.path.join(out, "poses")
    for d in (velo_dir, img_dir, pose_dir):
        os.makedirs(d, exist_ok=True)

    for i, scan in enumerate(fx.scans):
        scan.astype(np.float32).tofile(os.path.join(velo_dir, f"{i:06d}.bin"))
        img8 = np.clip(fx.images[i] * 255.0, 0, 255).astype(np.uint8)
        png.write_gray8(os.path.join(img_dir, f"{i:06d}.png"), img8)

    with open(os.path.join(seq_dir, "calib.txt"), "w") as f:
        p_line = " ".join(f"{v:.12e}" for v in fx.P.reshape(-1))
        for name in ("P0", "P1", "P2", "P3"):
            f.write(f"{name}: {p_line}\n")
        tr = fx.T_cam_velo[:3].reshape(-1)
        f.write("Tr: " + " ".join(f"{v:.12e}" for v in tr) + "\n")
    with open(os.path.join(seq_dir, "times.txt"), "w") as f:
        for t in fx.times:
            f.write(f"{t:.6e}\n")
    kitti.write_poses(os.path.join(pose_dir, f"{seq}.txt"), fx.gt_poses_cam)
    return seq_dir


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", required=True)
    ap.add_argument("--seq", default="00")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--rings", type=int, default=64)
    ap.add_argument("--azimuth", type=int, default=2048)
    ap.add_argument("--height", type=int, default=192)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    seq_dir = export(args.out, args.seq, args.frames, args.rings,
                     args.azimuth, args.height, args.width, args.seed)
    print(f"wrote {args.frames} frames to {seq_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
