"""The reference's pose error against ground truth on the drives of
``chip_smoke.py`` (64 x 2048 LiDAR, 4 frames, host pre-binned,
``klt_impl="pallas"``; seed 0 with 192 x 640 images, or with
``--batch-config`` the command line's ``--batch`` drives: 128 x 384
images, 128 tracks in 24 columns, seeds 100 + b), JAX on the CPU, beside
the port's on the CPU, for one ``--set`` of solver options:

    JAX_PLATFORMS=cpu python tests/reference_gt_error.py --set s:ct_sweep=1
    JAX_PLATFORMS=cpu python tests/reference_gt_error.py --set s:ct_sweep=1 \\
        --fused
    JAX_PLATFORMS=cpu python tests/reference_gt_error.py --set \\
        s:ct_sweep=1 --fused --batch-config --seed 101

It says what the reference itself reaches on that drive, where a
configuration does not meet the smoke script's ground-truth gates.  A
tool, not a test (pytest does not collect it); it imports both packages,
as the parity tests do.  Takes a few minutes and a few GB.
"""
import argparse
import os
import sys

import jax.numpy as jnp
import numpy as np
import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_HERE, os.path.dirname(_HERE)]

from velo_tpu import config as jconfig  # noqa: E402
from velo_tpu.geom import camera as jcam  # noqa: E402
from velo_tpu.io import fixtures  # noqa: E402
from velo_tpu.lidar import rangeimage as jri  # noqa: E402
from velo_tpu.pipeline import odometry as jodo  # noqa: E402
from velo_tpu_torch import config as tconfig  # noqa: E402
from velo_tpu_torch.geom import camera as tcam  # noqa: E402
from velo_tpu_torch.pipeline import odometry as todo  # noqa: E402
from test_torch_odometry import _pose_diff  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--set", dest="spec", default="")
    ap.add_argument("--fused", action="store_true")
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--batch-config", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    torch.set_num_threads(4)
    h, w = (128, 384) if args.batch_config else (192, 640)
    vision = dict(height=h, width=w, klt_impl="pallas")
    if args.batch_config:
        vision.update(k_tracks=128, grid_cols=24)
    kw = dict(lidar=dict(n_rings=64, n_azimuth=2048), vision=vision)
    cfgs = []
    for mod in (jconfig, tconfig):
        cfg = mod.VeloConfig(lidar=mod.LidarConfig(**kw["lidar"]),
                             vision=mod.VisionConfig(**kw["vision"]),
                             use_vision=args.fused, use_map=True,
                             prebin_host=True)
        cfgs.append(mod.apply_overrides(cfg, args.spec) if args.spec
                    else cfg)
    jc, tc = cfgs
    fx = fixtures.make_fixture(n_frames=args.frames, n_rings=64,
                               n_azimuth=2048, height=h, width=w,
                               with_images=args.fused, seed=args.seed)
    grids = [jri.bin_scan_host(s, jc.lidar) for s in fx.scans]
    gt = np.linalg.inv(fx.gt_poses_velo[0]) @ fx.gt_poses_velo
    if args.batch_config:  # the command line's pose files: camera frame
        T_cv = np.asarray(fx.T_cam_velo, np.float64)
        gt = np.linalg.inv(fx.gt_poses_cam[0]) @ fx.gt_poses_cam

    carry, jposes = jodo.init_carry(jc), []
    jcamera = jcam.Camera(P=jnp.asarray(fx.P, jnp.float32),
                          T_cam_velo=jnp.asarray(fx.T_cam_velo, jnp.float32),
                          width=w, height=h) if args.fused else None
    for i, (g, v) in enumerate(grids):
        img = jnp.asarray(fx.images[i]) if args.fused else None
        carry, out = jodo.jit_step(carry, jnp.asarray(g), jnp.asarray(v), jc,
                                   image=img, cam=jcamera)
        jposes.append(np.asarray(out.T_w))
    frames = [g + ((fx.images[i],) if args.fused else ())
              for i, g in enumerate(grids)]
    tposes, _, _ = todo.run_sequence(
        frames, tc, device="cpu",
        cam=tcam.from_numpy(fx.P, fx.T_cam_velo, w, h, "cpu")
        if args.fused else None)
    if args.batch_config:
        jposes = todo.velo_to_cam_trajectory(np.stack(jposes), T_cv)
        tposes = todo.velo_to_cam_trajectory(tposes, T_cv)
    for f in range(args.frames):
        ej, et = _pose_diff(jposes[f], gt[f]), _pose_diff(tposes[f], gt[f])
        d = _pose_diff(tposes[f], jposes[f])
        print(f"frame {f}: vs ground truth JAX {ej[0]:.4f} m {ej[1]:.4f} "
              f"deg, port {et[0]:.4f} m {et[1]:.4f} deg; port vs JAX "
              f"{d[0]:.4f} m {d[1]:.4f} deg")


if __name__ == "__main__":
    main()
