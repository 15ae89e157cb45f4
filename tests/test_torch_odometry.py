"""Port parity of the odometry loop, LiDAR-only and fused, and the port's
boundaries.

Both packages run the tiny configuration (32 x 1024, prebin, shipped
solver defaults; fused: 128 x 384 images, ``klt_impl="pallas"``) on the
same numpy fixture, JAX on the CPU with its Pallas kernels in interpret
mode.  Float32 rounding differs between the backends
(XLA fuses multiply-adds, the transcendental functions differ in the last
bit), and the PCA gates on flat synthetic ground decide on exactly such
bits, so poses are compared under tolerances, not bitwise:

* one step from a shared carry: 1 cm / 0.05 deg (measured ~2 mm / 0.01 deg);
* eight (fused: six) frames end to end: 5 cm / 0.1 deg on every frame,
  the gate of ``scripts/parity_check.py``.
"""
import dataclasses
import os
import subprocess
import sys

import jax
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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dataclasses.replace(jconfig.tiny_test_config(), use_vision=False,
                          use_map=True, prebin_host=True)
N_FRAMES = 8
FUSED = dataclasses.replace(
    jconfig.tiny_test_config(), use_vision=True, use_map=True,
    prebin_host=True, vision=dataclasses.replace(
        jconfig.tiny_test_config().vision, klt_impl="pallas"))
N_FUSED = 6


def _pose_diff(a, b):
    """(translation m, rotation deg) between two 4x4 poses."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    R = a[:3, :3].T @ b[:3, :3]
    # atan2 of sin and cos: arccos of the trace alone rounds small angles
    # of not-quite-orthonormal float32 rotations to 0.
    sin = np.linalg.norm([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                          R[1, 0] - R[0, 1]]) / 2.0
    cos = (np.trace(R) - 1.0) / 2.0
    return (float(np.linalg.norm(a[:3, 3] - b[:3, 3])),
            float(np.degrees(np.arctan2(sin, cos))))


@pytest.fixture(scope="module")
def frames():
    fx = fixtures.make_fixture(n_frames=N_FRAMES, n_rings=32, n_azimuth=1024,
                               with_images=False, seed=3)
    return [jri.bin_scan_host(s, CFG.lidar) for s in fx.scans]


@pytest.fixture(scope="module")
def reference(frames):
    """JAX run: per-frame poses, and the numpy carry entering each frame."""
    carry = jodo.init_carry(CFG)
    carries, poses = [], []
    for g, v in frames:
        carries.append(jax.tree.map(np.asarray, carry))
        carry, out = jodo.jit_step(carry, jnp.asarray(g), jnp.asarray(v),
                                   CFG)
        poses.append(np.asarray(out.T_w))
    return carries, np.stack(poses)


@pytest.mark.parametrize("frame", [0, 1, 2, 3])
def test_single_step_from_shared_carry(frames, reference, frame):
    carries, poses = reference
    carry = todo.carry_from_jax_numpy(carries[frame], "cpu")
    back = todo.carry_to_numpy(carry)
    for name in jodo.OdomCarry._fields:
        if name == "vision":
            continue
        for x, y in zip(jax.tree.leaves(getattr(back, name)),
                        jax.tree.leaves(getattr(carries[frame], name))):
            np.testing.assert_array_equal(x, y, name)
    assert carry.frame_host == frame

    g, v = frames[frame]
    new, out = todo.step(carry, torch.tensor(g), torch.tensor(v), CFG)
    dt, dr = _pose_diff(out.T_w.numpy(), poses[frame])
    print(f"frame {frame}: {dt:.5f} m, {dr:.5f} deg")
    assert dt < 0.01 and dr < 0.05
    assert new.frame_host == frame + 1 and int(new.frame_idx) == frame + 1


def test_eight_frames_end_to_end(frames, reference):
    _, ref_poses = reference
    poses, diags, carry = todo.run_sequence(frames, CFG, device="cpu")
    assert poses.shape == (N_FRAMES, 4, 4) and np.isfinite(poses).all()
    assert set(diags) == set(todo.FrameResult._fields) - {"T_w"}
    assert int(carry.frame_idx) == N_FRAMES
    worst = (0.0, 0.0)
    for f in range(N_FRAMES):
        dt, dr = _pose_diff(poses[f], ref_poses[f])
        print(f"frame {f}: {dt:.5f} m, {dr:.5f} deg")
        worst = (max(worst[0], dt), max(worst[1], dr))
    assert worst[0] < 0.05 and worst[1] < 0.1, worst


@pytest.fixture(scope="module")
def fused_frames():
    cfg = FUSED
    fx = fixtures.make_fixture(n_frames=N_FUSED, n_rings=cfg.lidar.n_rings,
                               n_azimuth=cfg.lidar.n_azimuth,
                               height=cfg.vision.height,
                               width=cfg.vision.width, seed=3)
    frames = [jri.bin_scan_host(s, cfg.lidar) + (img,)
              for s, img in zip(fx.scans, fx.images)]
    return frames, fx.P, fx.T_cam_velo


@pytest.fixture(scope="module")
def fused_reference(fused_frames):
    """JAX fused run: per-frame poses and n_depth, and the numpy carry
    entering each frame."""
    frames, P, T = fused_frames
    cam = jcam.Camera(P=jnp.asarray(P, jnp.float32),
                      T_cam_velo=jnp.asarray(T, jnp.float32),
                      width=FUSED.vision.width, height=FUSED.vision.height)
    carry = jodo.init_carry(FUSED)
    carries, poses, n_depth = [], [], []
    for g, v, img in frames:
        carries.append(jax.tree.map(np.asarray, carry))
        carry, out = jodo.jit_step(carry, jnp.asarray(g), jnp.asarray(v),
                                   FUSED, image=jnp.asarray(img), cam=cam)
        poses.append(np.asarray(out.T_w))
        n_depth.append(int(out.n_depth))
    return carries, np.stack(poses), np.array(n_depth)


def _tcam(P, T):
    return tcam.from_numpy(P, T, FUSED.vision.width, FUSED.vision.height,
                           "cpu")


@pytest.mark.parametrize("frame", [0, 1, 2, 3])
def test_fused_single_step_from_shared_carry(fused_frames, fused_reference,
                                             frame):
    frames, P, T = fused_frames
    carries, poses, n_depth = fused_reference
    carry = todo.carry_from_jax_numpy(carries[frame], "cpu")
    back = todo.carry_to_numpy(carry)
    for x, y in zip(jax.tree.leaves(back.vision),
                    jax.tree.leaves(carries[frame].vision)):
        np.testing.assert_array_equal(x, y)
    assert len(carry.vision.pyr) == FUSED.vision.pyr_levels

    g, v, img = frames[frame]
    new, out = todo.step(carry, torch.tensor(g), torch.tensor(v), FUSED,
                         image=torch.tensor(img), cam=_tcam(P, T))
    dt, dr = _pose_diff(out.T_w.numpy(), poses[frame])
    print(f"frame {frame}: {dt:.5f} m, {dr:.5f} deg, n_depth "
          f"{int(out.n_depth)} (JAX {n_depth[frame]})")
    assert dt < 0.01 and dr < 0.05
    # Track counts: one landmark may fall on either side of a gate.
    assert abs(int(out.n_depth) - n_depth[frame]) <= 2
    assert int(new.vision.tracks.active.sum()) > 0


def test_fused_frames_end_to_end(fused_frames, fused_reference):
    frames, P, T = fused_frames
    _, ref_poses, ref_depth = fused_reference
    poses, diags, carry = todo.run_sequence(frames, FUSED, device="cpu",
                                            cam=_tcam(P, T))
    assert poses.shape == (N_FUSED, 4, 4) and np.isfinite(poses).all()
    assert (ref_depth[2:] > 0).all()
    assert np.abs(diags["n_depth"] - ref_depth).max() <= 3
    assert carry.vision.tracks.uv.device.type == "cpu"
    worst = (0.0, 0.0)
    for f in range(N_FUSED):
        dt, dr = _pose_diff(poses[f], ref_poses[f])
        print(f"frame {f}: {dt:.5f} m, {dr:.5f} deg")
        worst = (max(worst[0], dt), max(worst[1], dr))
    assert worst[0] < 0.05 and worst[1] < 0.1, worst


def test_import_leaves_jax_out(tmp_path):
    """The port runs a fixture, one fused CPU step, the KITTI metric and
    the long-drive harness (a cached fixture, a scored trajectory, a run)
    without loading JAX or any file of ``velo_tpu/``, and its fixtures
    ignore ``VELO_FIX_ACCEL=1``."""
    code = (
        "import dataclasses, os, sys\n"
        "import numpy as np, torch\n"
        "import velo_tpu_torch as vt\n"
        "from velo_tpu_torch.geom import camera\n"
        "from velo_tpu_torch.lidar import rangeimage\n"
        "from velo_tpu_torch.pipeline import odometry\n"
        "from velo_tpu_torch.kernels import dist_topk, klt_l0, _build\n"
        "cfg = vt.config.tiny_test_config()\n"
        "cfg = dataclasses.replace(cfg, prebin_host=True, vision="
        "dataclasses.replace(cfg.vision, klt_impl='pallas'))\n"
        "fx = vt.fixtures.make_fixture(n_frames=1, n_rings=32, "
        "n_azimuth=1024, height=128, width=384, seed=5)\n"
        "cam = camera.from_numpy(fx.P, fx.T_cam_velo, 384, 128)\n"
        "frame = rangeimage.bin_scan_host(fx.scans[0], cfg.lidar) "
        "+ (fx.images[0],)\n"
        "poses, _, carry = odometry.run_sequence([frame], cfg, "
        "device='cpu', cam=cam)\n"
        "assert carry.vision.tracks.active.any()\n"
        "vt.kitti_metric.evaluate_trajectory(np.stack([np.eye(4)] * 3), "
        "np.stack([np.eye(4)] * 3))\n"
        "from velo_tpu_torch.evaluation import longrun\n"
        "s, m, gv, gc, tcv, _, _ = longrun.get_fixture(2, 16, 256, seed=5, "
        "cache_dir=%r)\n"
        "row, _, _ = longrun.metrics_row('base', 5, gv, gv, gc, tcv, "
        "np.zeros(2, bool), 1.0)\n"
        "assert row['ate_m'] == 0.0 and row['med_rel_err_m'] == 0.0, row\n"
        "rows = longrun.main(['--device', 'cpu', '--frames', '2', '--rings', "
        "'16', '--azimuth', '256', '--seeds', '5', '--cache-dir', %r])\n"
        "assert rows[0]['ate_m'] < 0.2, rows\n"
        "ref = os.path.join(%r, 'velo_tpu') + os.sep\n"
        "bad = [m for m, mod in list(sys.modules.items()) if "
        "m.split('.')[0] in ('jax', 'jaxlib', 'velo_tpu') or "
        "(getattr(mod, '__file__', None) or '').startswith(ref)]\n"
        "assert not bad, bad\n"
        "print('ok')\n") % (str(tmp_path), str(tmp_path), REPO)
    env = dict(os.environ, PYTHONPATH=REPO, VELO_FIX_ACCEL="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "ok"


def test_entry_points_default_to_the_card(monkeypatch, frames):
    """Without ``device`` the entry points take the card; without a card
    they raise and never fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: todo.init_carry(CFG),
                 lambda: todo.run_sequence(frames[:1], CFG),
                 lambda: todo.carry_from_jax_numpy(None)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert todo.init_carry(CFG, device="cpu").T_w.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert todo.resolve_device(None) == torch.device("cuda")
    assert todo.resolve_device("cpu") == torch.device("cpu")


@pytest.mark.cuda
def test_init_carry_lands_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    carry = todo.init_carry(FUSED)
    assert carry.T_w.is_cuda and carry.vision.tracks.uv.is_cuda


# ----- the variants the command line can select ---------------------------

def _variant_cfg(name):
    if name == "fast":  # --fast
        return jconfig.apply_overrides(CFG, jconfig.FAST_PRESET)
    if name == "deferred":
        return jconfig.apply_overrides(CFG, "s:prior_obs_impl=deferred")
    if name == "degen":
        return jconfig.apply_overrides(CFG, "s:degen_rel_min=0.01")
    assert name == "no_prebin"  # --no-prebin
    return dataclasses.replace(CFG, prebin_host=False)


@pytest.fixture(scope="module")
def raw_scans():
    fx = fixtures.make_fixture(n_frames=N_FRAMES, n_rings=32, n_azimuth=1024,
                               with_images=False, seed=3)
    return fx.scans


def _variant_frames(name, frames, raw_scans):
    if name != "no_prebin":
        return frames
    from velo_tpu.io import kitti
    return [kitti.pad_scan(s, CFG.n_max_points) for s in raw_scans]


@pytest.fixture(scope="module")
def variant_reference(frames, raw_scans):
    """Per variant, computed once: the JAX run's per-frame poses and the
    numpy carry entering each frame."""
    cache = {}

    def get(name):
        if name not in cache:
            cfg = _variant_cfg(name)
            carry = jodo.init_carry(cfg)
            carries, poses = [], []
            for s, m in _variant_frames(name, frames, raw_scans):
                carries.append(jax.tree.map(np.asarray, carry))
                carry, out = jodo.jit_step(carry, jnp.asarray(s),
                                           jnp.asarray(m), cfg)
                poses.append(np.asarray(out.T_w))
            cache[name] = (carries, np.stack(poses))
        return cache[name]

    return get


@pytest.mark.parametrize("frame", [1, 3])
@pytest.mark.parametrize("name", ["fast", "deferred", "degen", "no_prebin"])
def test_variant_single_step_from_shared_carry(frames, raw_scans,
                                               variant_reference, name,
                                               frame):
    cfg = _variant_cfg(name)
    carries, poses = variant_reference(name)
    carry = todo.carry_from_jax_numpy(carries[frame], "cpu")
    s, m = _variant_frames(name, frames, raw_scans)[frame]
    _, out = todo.step(carry, torch.tensor(s), torch.tensor(m), cfg)
    dt, dr = _pose_diff(out.T_w.numpy(), poses[frame])
    print(f"{name} frame {frame}: {dt:.5f} m, {dr:.5f} deg")
    assert dt < 0.01 and dr < 0.05


@pytest.mark.parametrize("name", ["fast", "no_prebin"])
def test_variant_eight_frames_end_to_end(frames, raw_scans,
                                         variant_reference, name):
    cfg = _variant_cfg(name)
    _, ref_poses = variant_reference(name)
    poses, _ = todo.run_sequence_host(
        _variant_frames(name, frames, raw_scans), cfg, device="cpu")
    assert poses.shape == (N_FRAMES, 4, 4) and np.isfinite(poses).all()
    worst = (0.0, 0.0)
    for f in range(N_FRAMES):
        dt, dr = _pose_diff(poses[f], ref_poses[f])
        print(f"{name} frame {f}: {dt:.5f} m, {dr:.5f} deg")
        worst = (max(worst[0], dt), max(worst[1], dr))
    assert worst[0] < 0.05 and worst[1] < 0.1, worst


@pytest.mark.parametrize("change", [
    {"v:klt_impl": "matmul"},
    {"v:klt_impl": "window"},
    {"s:nn_approx_impl": "xla"},
])
def test_configs_outside_the_slice_are_refused(frames, fused_frames, change):
    """The reference's matmul and window samplers and its XLA top-k run
    (two steps on the CPU, poses finite); an unknown value of the same
    field raises ValueError before any work."""
    (key, value), = change.items()

    def with_value(v):
        if key.startswith("s:"):
            return dataclasses.replace(CFG, solver=dataclasses.replace(
                CFG.solver, **{key[2:]: v}))
        return dataclasses.replace(FUSED, vision=dataclasses.replace(
            FUSED.vision, **{key[2:]: v}))

    cfg = with_value(value)
    if cfg.use_vision:
        fr, P, T = fused_frames
        cam = _tcam(P, T)
    else:
        fr, cam = frames, None
    carry = todo.init_carry(cfg, device="cpu")
    for frame in fr[:2]:
        img = torch.tensor(frame[2]) if cfg.use_vision else None
        carry, out = todo.step(carry, torch.tensor(frame[0]),
                               torch.tensor(frame[1]), cfg, image=img,
                               cam=cam)
        assert torch.isfinite(out.T_w).all()
    assert carry.frame_host == 2

    bogus = with_value("bogus")
    with pytest.raises(ValueError, match="bogus"):
        todo.init_carry(bogus, device="cpu")
    with pytest.raises(ValueError, match="bogus"):
        todo.step(carry, torch.tensor(fr[0][0]), torch.tensor(fr[0][1]),
                  bogus, image=torch.tensor(fr[0][2]) if cfg.use_vision
                  else None, cam=cam)
