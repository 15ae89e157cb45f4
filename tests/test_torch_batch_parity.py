"""Port parity of config 5, fused: ``velo_tpu_torch.pipeline.batch``
against ``velo_tpu.pipeline.batch`` on the same inputs.

Two sequences (the batch mode's seeds 100 and 101) of three frames at the
shapes of ``tiny_test_config()``, fused with the shipped ``klt_impl=
"auto"``, through both packages' ``run_sequences`` on the CPU (JAX's
``jax.vmap`` over its scan, the port's ``torch.func.vmap`` over its step).
Every frame of every sequence within 5 cm / 0.1 deg, the end-to-end gate
of the odometry tests.  The LiDAR-only batch through both command lines
is ``tests/test_torch_batch_cli.py``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from velo_tpu import config as jconfig
from velo_tpu.geom import camera as jcam
from velo_tpu.pipeline import batch as jbatch
from velo_tpu_torch import config as tconfig
from velo_tpu_torch.geom import camera as tcam
from velo_tpu_torch.io import fixtures
from velo_tpu_torch.lidar import rangeimage as ri
from velo_tpu_torch.pipeline import batch as tbatch
from test_torch_odometry import _pose_diff

torch.set_num_threads(1)

N_FRAMES = 3
SEEDS = (100, 101)


def test_fused_batch_against_the_reference():
    cfg = dataclasses.replace(jconfig.tiny_test_config(), use_vision=True,
                              use_map=True, prebin_host=True)
    assert cfg.vision.klt_impl == "auto"
    vc = cfg.vision
    drives = [fixtures.make_fixture(
        n_frames=N_FRAMES, n_rings=cfg.lidar.n_rings,
        n_azimuth=cfg.lidar.n_azimuth, height=vc.height, width=vc.width,
        seed=s) for s in SEEDS]
    grids = [[ri.bin_scan_host(s, cfg.lidar) for s in fx.scans]
             for fx in drives]
    scans = np.stack([np.stack([g[0] for g in gs]) for gs in grids])
    masks = np.stack([np.stack([g[1] for g in gs]) for gs in grids])
    images = np.stack([fx.images for fx in drives])
    P, T_cv = drives[0].P, drives[0].T_cam_velo

    j_poses, j_diag = jbatch.run_sequences(
        scans, masks, cfg, images=images,
        cam=jcam.Camera(P=jnp.asarray(P, jnp.float32),
                        T_cam_velo=jnp.asarray(T_cv, jnp.float32),
                        width=vc.width, height=vc.height))
    t_poses, t_diag = tbatch.run_sequences(
        scans, masks, dataclasses.replace(
            tconfig.tiny_test_config(), use_vision=True, use_map=True,
            prebin_host=True),
        images=images, cam=tcam.from_numpy(P, T_cv, vc.width, vc.height,
                                           "cpu"), device="cpu")
    assert t_poses.shape == j_poses.shape == (len(SEEDS), N_FRAMES, 4, 4)
    assert set(t_diag) == set(j_diag)
    worst = (0.0, 0.0)
    for b in range(len(SEEDS)):
        for f in range(N_FRAMES):
            dt, dr = _pose_diff(t_poses[b, f], j_poses[b, f])
            worst = (max(worst[0], dt), max(worst[1], dr))
    print(f"fused batch: worst frame {worst[0]:.5f} m, {worst[1]:.5f} deg")
    assert worst[0] < 0.05 and worst[1] < 0.1, worst
