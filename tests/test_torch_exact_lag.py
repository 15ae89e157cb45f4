"""Port parity of the exact-lag deskew (``deskew_exact_lag``): the
previous scan's targets re-corrected with the motion solved now (and the
candidate cache with them), and the map insert of the previous scan at
the previous pose, one frame late.

Against JAX on the tiny drive of ``test_torch_odometry.py``: one step from
a shared carry 1 cm / 0.05 deg at frames 2 and 3, four frames end to end
5 cm / 0.1 deg.  At frames 0 and 1 the re-correction is the identity and
the map is still empty, so the step is the plain step without a map
(``--no-map``), judged in ``ROADMAP.md`` Queue 3.  Then the port's
counterpart of the reference's own contract: under constant velocity the
exact lag is (nearly) the identity.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from velo_tpu import config as jconfig
from velo_tpu.io import fixtures
from velo_tpu.lidar import rangeimage as jri
from velo_tpu.pipeline import odometry as jodo
from velo_tpu_torch import config as tconfig
from velo_tpu_torch.io import fixtures as tfix
from velo_tpu_torch.io import kitti as tkitti
from velo_tpu_torch.pipeline import odometry as todo
from test_torch_odometry import _pose_diff

torch.set_num_threads(1)

N_FRAMES = 4
CFG = jconfig.apply_overrides(dataclasses.replace(
    jconfig.tiny_test_config(), use_vision=False, use_map=True,
    prebin_host=True), "s:deskew_exact_lag=1")


@pytest.fixture(scope="module")
def frames():
    fx = fixtures.make_fixture(n_frames=N_FRAMES, n_rings=32, n_azimuth=1024,
                               with_images=False, seed=3)
    return [jri.bin_scan_host(s, CFG.lidar) for s in fx.scans]


@pytest.fixture(scope="module")
def reference(frames):
    carry = jodo.init_carry(CFG)
    carries, poses = [], []
    for g, v in frames:
        carries.append(jax.tree.map(np.asarray, carry))
        carry, out = jodo.jit_step(carry, jnp.asarray(g), jnp.asarray(v),
                                   CFG)
        poses.append(np.asarray(out.T_w))
    return carries, np.stack(poses)


@pytest.mark.parametrize("frame", [2, 3])
def test_exact_lag_single_step_from_shared_carry(frames, reference, frame):
    carries, poses = reference
    carry = todo.carry_from_jax_numpy(carries[frame], "cpu")
    g, v = frames[frame]
    _, out = todo.step(carry, torch.tensor(g), torch.tensor(v), CFG)
    dt, dr = _pose_diff(out.T_w.numpy(), poses[frame])
    print(f"exact lag frame {frame}: {dt:.5f} m, {dr:.5f} deg")
    assert dt < 0.01 and dr < 0.05


def test_exact_lag_frames_end_to_end(frames, reference):
    _, ref_poses = reference
    poses, diags, _ = todo.run_sequence(frames, CFG, device="cpu")
    assert poses.shape == (N_FRAMES, 4, 4) and np.isfinite(poses).all()
    assert diags["map_applied"][2:].all()
    worst = (0.0, 0.0)
    for f in range(N_FRAMES):
        dt, dr = _pose_diff(poses[f], ref_poses[f])
        print(f"exact lag frame {f}: {dt:.5f} m, {dr:.5f} deg")
        worst = (max(worst[0], dt), max(worst[1], dr))
    assert worst[0] < 0.05 and worst[1] < 0.1, worst


def test_exact_lag_identity_under_constant_velocity():
    """The port's counterpart of the reference's
    ``test_exact_lag_deskew_identity_under_constant_velocity``: on a
    constant-velocity drive the exact-lag corrections are identities, so
    the two settings differ by no more than their own errors against
    ground truth, exact lag is not worse at the end, and both track the
    relative motion."""
    fx = tfix.make_fixture(n_frames=6, n_rings=32, n_azimuth=1024,
                           with_images=False, speed=8.0, yaw_rate=0.0,
                           wiggle_scale=0.0)
    cfg_off = tconfig.VeloConfig(
        lidar=tconfig.LidarConfig(n_rings=32, n_azimuth=1024),
        map=tconfig.MapConfig(edge_capacity=8192, planar_capacity=16384),
        n_max_points=32 * 1024, use_vision=False, use_map=True)
    frames = [tkitti.pad_scan(s, cfg_off.n_max_points) for s in fx.scans]
    cfg_on = tconfig.apply_overrides(cfg_off, "s:deskew_exact_lag=1")
    poses_on, _, _ = todo.run_sequence(frames, cfg_on, device="cpu")
    poses_off, _, _ = todo.run_sequence(frames, cfg_off, device="cpu")
    gt = fx.gt_poses_velo
    for i in (2, 4, 5):
        d = np.linalg.norm(poses_on[i][:3, 3] - poses_off[i][:3, 3])
        e_on = np.linalg.norm(poses_on[i][:3, 3] - gt[i][:3, 3])
        e_off = np.linalg.norm(poses_off[i][:3, 3] - gt[i][:3, 3])
        assert d <= e_on + e_off + 1e-6, (i, d, e_on, e_off)
    e_on = np.linalg.norm(poses_on[-1][:3, 3] - gt[-1][:3, 3])
    e_off = np.linalg.norm(poses_off[-1][:3, 3] - gt[-1][:3, 3])
    print(f"frame 5 error vs ground truth: exact lag {e_on:.4f} m, plain "
          f"{e_off:.4f} m")
    assert e_on < e_off + 0.02, (e_on, e_off)
    for poses, bound in ((poses_on, 0.05), (poses_off, 0.2)):
        rel_est = np.linalg.inv(poses[4]) @ poses[5]
        rel_gt = np.linalg.inv(gt[4]) @ gt[5]
        assert np.linalg.norm(rel_est[:3, 3] - rel_gt[:3, 3]) < bound
