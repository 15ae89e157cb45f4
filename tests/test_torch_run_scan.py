"""The device-resident entries on the CPU: ``odometry.run_scan`` and
``jit_step`` (on the card CUDA-graph replays, here the step itself), and
the cadence key that picks a captured graph.

* ``run_scan`` is bitwise equal to ``run_sequence`` on the same frames,
  LiDAR-only and fused (``klt_impl="pallas"``): on the CPU both run the
  same step;
* with ``map_every = 2`` the cadence key alternates, the frames that skip
  the scan-to-map refinement accept no map step, and the two entries
  still agree bitwise;
* against ``velo_tpu.pipeline.odometry.run_scan`` over 3 frames of the
  tiny LiDAR drive within 5 cm / 0.1 deg, the end-to-end gate of
  ``test_torch_odometry.py`` (the fused comparison is in
  ``test_torch_run_scan_fused.py``: JAX compiles a fused scan for ~50 s
  here).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from velo_tpu import config as jconfig
from velo_tpu.geom import camera as jcam
from velo_tpu.io import fixtures
from velo_tpu.lidar import rangeimage as jri
from velo_tpu.pipeline import odometry as jodo
from velo_tpu_torch.geom import camera as tcam
from velo_tpu_torch.pipeline import odometry as todo

torch.set_num_threads(1)

N_FRAMES = 3
BASE = jconfig.tiny_test_config()


def config(fused: bool, **changes):
    cfg = dataclasses.replace(
        BASE, use_vision=fused, use_map=True, prebin_host=True,
        vision=dataclasses.replace(BASE.vision, klt_impl="pallas"))
    return dataclasses.replace(cfg, **changes)


@pytest.fixture(scope="module")
def drive():
    """(scans (F, R, W, 5), masks (F, R, W), images (F, H, W), P, T)."""
    fx = fixtures.make_fixture(n_frames=N_FRAMES, n_rings=BASE.lidar.n_rings,
                               n_azimuth=BASE.lidar.n_azimuth,
                               height=BASE.vision.height,
                               width=BASE.vision.width, seed=3)
    grids = [jri.bin_scan_host(s, BASE.lidar) for s in fx.scans]
    return (np.stack([g[0] for g in grids]), np.stack([g[1] for g in grids]),
            np.stack(fx.images).astype(np.float32), fx.P, fx.T_cam_velo)


def port_scan(drive, cfg):
    scans, masks, images, P, T = drive
    cam = (tcam.from_numpy(P, T, cfg.vision.width, cfg.vision.height, "cpu")
           if cfg.use_vision else None)
    return todo.run_scan(todo.init_carry(cfg, "cpu"), torch.tensor(scans),
                         torch.tensor(masks), cfg,
                         images=torch.tensor(images) if cfg.use_vision
                         else None, cam=cam)


def port_sequence(drive, cfg):
    scans, masks, images, P, T = drive
    cam = (tcam.from_numpy(P, T, cfg.vision.width, cfg.vision.height, "cpu")
           if cfg.use_vision else None)
    frames = [(s, m) + ((im,) if cfg.use_vision else ())
              for s, m, im in zip(scans, masks, images)]
    return todo.run_sequence(frames, cfg, device="cpu", cam=cam)


def _assert_same(out, poses, diags):
    assert np.array_equal(out.T_w.numpy(), poses)
    for k, v in diags.items():
        assert np.array_equal(getattr(out, k).numpy(), v), k


@pytest.mark.parametrize("fused", [False, True])
def test_run_scan_equals_run_sequence(drive, fused):
    cfg = config(fused)
    carry, out = port_scan(drive, cfg)
    poses, diags, seq_carry = port_sequence(drive, cfg)
    assert out.T_w.shape == (N_FRAMES, 4, 4)
    assert all(getattr(out, k).shape[0] == N_FRAMES for k in out._fields)
    _assert_same(out, poses, diags)
    assert carry.frame_host == N_FRAMES == int(carry.frame_idx)
    assert torch.equal(carry.T_w, seq_carry.T_w)
    assert torch.equal(carry.edge_map.pts, seq_carry.edge_map.pts)


def test_jit_step_on_the_cpu_is_the_step(drive):
    cfg = config(False)
    scans, masks = (torch.tensor(x) for x in drive[:2])
    carry = todo.init_carry(cfg, "cpu")
    a = todo.jit_step(carry, scans[0], masks[0], cfg)
    b = todo.step(carry, scans[0], masks[0], cfg)
    assert a[0].frame_host == b[0].frame_host == 1
    for x, y in zip(a[1], b[1]):
        assert torch.equal(x, y)


def test_cadence_key_at_map_every_2(drive):
    cfg = config(False, map=dataclasses.replace(BASE.map, map_every=2,
                                                maintain_every=3))
    keys = [todo.cadence_key(cfg, f) for f in range(6)]
    assert keys == [(True, True), (False, False), (True, False),
                    (False, True), (True, False), (False, False)]
    assert len(set(keys)) == 4  # at most four graphs per configuration
    assert todo.cadence_key(config(False, use_map=False), 5) == ()
    _, out = port_scan(drive, cfg)
    poses, diags, _ = port_sequence(drive, cfg)
    _assert_same(out, poses, diags)
    # A frame off the refinement cadence takes no map step.
    assert int(out.lm_accept_map[1]) == 0 and not bool(out.map_applied[1])


def jax_scan(drive, cfg):
    scans, masks, images, P, T = drive
    cam = None
    if cfg.use_vision:
        cam = jcam.Camera(P=jnp.asarray(P, jnp.float32),
                          T_cam_velo=jnp.asarray(T, jnp.float32),
                          width=cfg.vision.width, height=cfg.vision.height)
    _, out = jodo.run_scan(jodo.init_carry(cfg), jnp.asarray(scans),
                           jnp.asarray(masks), cfg,
                           images=jnp.asarray(images) if cfg.use_vision
                           else None, cam=cam)
    return np.asarray(out.T_w)


def assert_poses_close(port, ref):
    """5 cm / 0.1 deg on every frame."""
    from test_torch_odometry import _pose_diff

    for f in range(len(ref)):
        dt, dr = _pose_diff(port[f], ref[f])
        assert dt < 0.05 and dr < 0.1, (f, dt, dr)


def test_run_scan_against_jax_lidar(drive):
    cfg = config(False)
    _, out = port_scan(drive, cfg)
    assert_poses_close(out.T_w.numpy(), jax_scan(drive, cfg))
