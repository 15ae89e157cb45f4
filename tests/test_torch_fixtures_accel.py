"""The port's accelerated drive simulator, ``velo_tpu_torch.io.
fixtures_accel`` (``VELO_FIX_ACCEL=1``), against the reference's JAX
raycaster ``velo_tpu.io.fixtures_accel`` (JAX on the CPU) and against the
port's own numpy simulator.  Every port call passes ``device="cpu"``.

Tolerances:

* LiDAR hit distances, and so the scans of a fixture: bitwise equal to
  JAX's (the slab test is subtractions, products, IEEE division, min / max
  and compares in float32; the noise and dropout draws are the same numpy
  calls);
* camera images: bitwise equal but for at most 1 % of pixels, each within
  two float32 ulps of 1 (1.2e-7).  The port rounds sin from float64 where
  XLA evaluates its own float32 sin; measured on the CPU: 55 of 9216
  pixels differ, by at most 6.0e-8, at 2 x 48 x 96 (default_world(1));
* against the numpy simulator: the reference's own bounds
  (``tests/unit/test_fixtures_accel.py``): scan lengths within
  max(2, 0.1 %), 99th percentile of point distance over the common prefix
  below 1 mm; images 99.9th percentile of |diff| below 1e-2, mean below
  1e-4.
"""
import ast
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from velo_tpu.io import fixtures as jfix
from velo_tpu.io import fixtures_accel as jacc
from velo_tpu_torch.io import fixtures as tfix
from velo_tpu_torch.io import fixtures_accel as tacc
from velo_tpu_torch.lidar.rangeimage import hdl64e_beam_elevations

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
IMG_ULPS = 1.2e-7  # two float32 ulps of 1.0's binade below it
IMG_SHARE = 0.01  # pixels allowed to differ from JAX's in the last bits
# The reference's parity test's drive (tests/unit/test_fixtures_accel.py).
FIXTURE_KW = dict(n_frames=3, n_rings=16, n_azimuth=256, height=48,
                  width=96, with_images=True, speed=8.0, seed=3)
NOISE_DROPOUT = [(0.0, 0.0), (0.02, 0.05)]


def _images_close(a, b):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    assert d.max() <= IMG_ULPS, d.max()
    assert (d > 0).mean() <= IMG_SHARE, (d > 0).mean()


def _sweep_kw(rays):
    rings, az, beams, az_start = rays
    return dict(n_rings=rings, n_azimuth=az, elev_max_deg=2.0,
                elev_min_deg=-24.8, max_range=80.0,
                beam_elev=hdl64e_beam_elevations(rings) if beams else None,
                az_start=az_start)


@pytest.mark.parametrize("rays", [(8, 128, False, 0.0),
                                  (16, 256, True, float(np.pi))],
                         ids=["uniform-8x128", "hdl64e-16x256-rear"])
def test_sweep_hits_bitwise_equal_to_jax(rays):
    """The reference test's rays (default_world(1), trajectory seed 5),
    and a real beam table with the sweep starting at the rear: every hit
    distance and the shared directions bit for bit."""
    world = jfix.default_world(1)
    poses = jfix.make_trajectory(3, speed=8.0, seed=5)
    tj, dj = jacc.simulate_sweep_batch(world, poses, **_sweep_kw(rays))
    tt, dt = tacc.simulate_sweep_batch(tfix.default_world(1), poses,
                                       **_sweep_kw(rays), device="cpu")
    assert tt.dtype == np.float32 and tt.shape == (2, rays[0] * rays[1])
    assert np.isinf(tt).any() and np.isfinite(tt).any()
    np.testing.assert_array_equal(tt, tj)
    np.testing.assert_array_equal(dt, dj)
    # A chunk that does not divide the rays: the same bits.
    origins = np.random.default_rng(0).normal(0, 5, (2, 100, 3))
    dirs = np.random.default_rng(1).normal(0, 1, (2, 100, 3))
    dirs[0, :10, 1] = 0.0  # axis-parallel rays take the 1e-12 guard
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    o32, d32 = origins.astype(np.float32), dirs.astype(np.float32)
    np.testing.assert_array_equal(
        tacc._sweep_hits(world.mins, world.maxs, o32, d32, 80.0, chunk=37,
                         device="cpu"),
        jacc._sweep_hits(world.mins, world.maxs, o32, d32, 80.0))


@pytest.mark.parametrize("world", ["default", "suburban"])
def test_render_batch_matches_jax(world):
    """2 frames at 48 x 96 through both renderers."""
    w = (jfix.default_world(1) if world == "default"
         else jfix.suburban_world(1))
    poses = jfix.make_trajectory(3, speed=8.0, seed=5)
    P, T_cv = jfix.default_calib(48, 96)
    T_w_cams = [poses[i] @ np.linalg.inv(T_cv) for i in range(2)]
    ij = jacc.render_batch(w, T_w_cams, P, 48, 96)
    it = tacc.render_batch(w, T_w_cams, P, 48, 96, device="cpu")
    assert it.shape == (2, 48, 96) and it.dtype == np.float32
    assert (it == np.float32(0.08)).any() and (it != np.float32(0.08)).any()
    _images_close(it, ij)


def _make(module, monkeypatch, **kw):
    monkeypatch.setenv("VELO_FIX_ACCEL", "1")
    return module.make_fixture(**kw)


@pytest.mark.parametrize("noise_std,dropout", NOISE_DROPOUT)
def test_make_fixture_accel_matches_jax(monkeypatch, noise_std, dropout):
    """``make_fixture`` with the switch on, port against reference: scans
    and poses bitwise, images within the render tolerance."""
    kw = dict(FIXTURE_KW, noise_std=noise_std, dropout=dropout)
    ref = _make(jfix, monkeypatch, **kw)
    ours = _make(tfix, monkeypatch, device="cpu", **kw)
    assert len(ours.scans) == len(ref.scans) == 3
    for a, b in zip(ours.scans, ref.scans):
        np.testing.assert_array_equal(a, b)
    for name in ("gt_poses_velo", "gt_poses_cam", "P", "T_cam_velo",
                 "times"):
        np.testing.assert_array_equal(getattr(ours, name), getattr(ref, name))
    _images_close(ours.images, ref.images)


@pytest.mark.parametrize("noise_std,dropout", NOISE_DROPOUT)
def test_make_fixture_accel_against_numpy(monkeypatch, noise_std, dropout):
    """The port's accelerated path against its own numpy path, within the
    reference's bounds for its own two paths."""
    kw = dict(FIXTURE_KW, noise_std=noise_std, dropout=dropout)
    monkeypatch.setenv("VELO_FIX_ACCEL", "0")
    ref = tfix.make_fixture(**kw)
    acc = _make(tfix, monkeypatch, device="cpu", **kw)
    np.testing.assert_array_equal(acc.gt_poses_velo, ref.gt_poses_velo)
    for s_ref, s_acc in zip(ref.scans, acc.scans):
        n = min(len(s_ref), len(s_acc))
        assert abs(len(s_ref) - len(s_acc)) <= max(2, 0.001 * n)
        d = np.linalg.norm(s_ref[:n, :3] - s_acc[:n, :3], axis=1)
        assert np.percentile(d, 99) < 1e-3, d.max()
    d = np.abs(ref.images - acc.images)
    assert np.percentile(d, 99.9) < 1e-2
    assert d.mean() < 1e-4


@pytest.mark.parametrize("entry", ["make_fixture", "simulate_sweep_batch",
                                   "render_batch"])
def test_runs_on_the_card_by_default(monkeypatch, entry):
    """Without a card and without ``device="cpu"`` the switch raises; it
    never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("VELO_FIX_ACCEL", "1")
    world = tfix.default_world(1)
    poses = tfix.make_trajectory(2, speed=8.0, seed=5)
    P, T_cv = tfix.default_calib(8, 16)
    call = {
        "make_fixture": lambda: tfix.make_fixture(
            n_frames=1, n_rings=4, n_azimuth=16, height=8, width=16),
        "simulate_sweep_batch": lambda: tacc.simulate_sweep_batch(
            world, poses, **_sweep_kw((4, 16, False, 0.0))),
        "render_batch": lambda: tacc.render_batch(
            world, [poses[0] @ np.linalg.inv(T_cv)], P, 8, 16),
    }[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()


@pytest.mark.parametrize("path", ["velo_tpu_torch/io/fixtures_accel.py",
                                  "velo_tpu_torch/io/fixtures.py",
                                  "velo_tpu_torch/evaluation/longrun.py"])
def test_imports_nothing_of_jax_or_the_reference(path):
    """The simulator and its callers import torch and numpy, never JAX or
    ``velo_tpu`` (the card's machine has neither)."""
    tree = ast.parse((REPO / path).read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    assert names
    for name in names:
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "velo_tpu"), (path, name)


def test_switch_off_leaves_the_numpy_path(monkeypatch):
    """``VELO_FIX_ACCEL`` other than "1": the numpy simulator, which never
    touches torch (no device needed, even without a card)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for value in ("0", ""):
        monkeypatch.setenv("VELO_FIX_ACCEL", value)
        kw = dict(n_frames=1, n_rings=8, n_azimuth=64, height=8, width=16,
                  seed=1)
        a, b = tfix.make_fixture(**kw), jfix.make_fixture(**kw)
        np.testing.assert_array_equal(a.scans[0], b.scans[0])
        np.testing.assert_array_equal(a.images, b.images)
    assert os.environ["VELO_FIX_ACCEL"] == ""
