"""Port parity: host pre-binning, range image (pre-binned and raw-scan
path), curvature, feature selection.

One numpy fixture frame goes through ``velo_tpu`` (JAX, CPU) and
``velo_tpu_torch``.  The curvature and feature stages are fed the same
range image, so their masks and picks must be identical; the range image
itself is compared after a deskew with a non-zero motion, where the
backends' sin/cos differ in the last bit.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from velo_tpu import config as jconfig
from velo_tpu.io import fixtures
from velo_tpu.io.kitti import pad_scan
from velo_tpu.lidar import curvature as jcurv
from velo_tpu.lidar import deskew as jdeskew
from velo_tpu.lidar import features as jfeat
from velo_tpu.lidar import rangeimage as jri
from velo_tpu_torch.lidar import curvature as tcurv
from velo_tpu_torch.lidar import deskew as tdeskew
from velo_tpu_torch.lidar import features as tfeat
from velo_tpu_torch.lidar import rangeimage as tri

torch.set_num_threads(1)

CFG = jconfig.tiny_test_config().lidar
DELTA = np.array([0.8, 0.03, 0.01, 0.002, -0.003, 0.04], np.float32)


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.fixture(scope="module")
def scans():
    fx = fixtures.make_fixture(n_frames=2, n_rings=CFG.n_rings,
                               n_azimuth=CFG.n_azimuth, with_images=False,
                               seed=3)
    return fx.scans


@pytest.fixture(scope="module")
def ref_ri(scans):
    """The reference's deskewed range image of frame 1, as numpy."""
    g, v = jri.bin_scan_host(scans[1], CFG)
    ri = jri.range_image_from_grid(jnp.asarray(g), jnp.asarray(v),
                                   jnp.asarray(DELTA), CFG)
    return jri.RangeImage(*(np.asarray(x) for x in ri))


@pytest.mark.parametrize("ring_mode", ["linear", "hdl64e"])
def test_bin_scan_host_bitwise(scans, ring_mode):
    cfg = dataclasses.replace(CFG, ring_mode=ring_mode)
    g_j, v_j = jri.bin_scan_host(scans[0], cfg)
    g_t, v_t = tri.bin_scan_host(scans[0], cfg)
    assert v_j.any()
    np.testing.assert_array_equal(v_t, v_j)
    np.testing.assert_array_equal(g_t, g_j)


def test_range_image_from_grid(scans, ref_ri):
    g, v = tri.bin_scan_host(scans[1], CFG)
    ri = tri.range_image_from_grid(_t(g), _t(v), _t(DELTA), CFG)
    np.testing.assert_array_equal(ri.valid.numpy(), ref_ri.valid)
    np.testing.assert_array_equal(ri.phase.numpy(), ref_ri.phase)
    # 1e-5 m, plus 2e-7 relative: two float32 ulps of an 80 m return.
    np.testing.assert_allclose(ri.xyz.numpy(), ref_ri.xyz, atol=1e-5,
                               rtol=2e-7)
    np.testing.assert_allclose(ri.rng.numpy(), ref_ri.rng, atol=1e-5,
                               rtol=2e-7)


def test_compute_curvature(ref_ri):
    cr_j = jcurv.compute_curvature(
        jri.RangeImage(*(jnp.asarray(x) for x in ref_ri)), CFG)
    cr_t = tcurv.compute_curvature(
        tri.RangeImage(*(_t(x) for x in ref_ri)), CFG)
    for name in ("scored", "edge_ok", "planar_ok"):
        np.testing.assert_array_equal(getattr(cr_t, name).numpy(),
                                      np.asarray(getattr(cr_j, name)), name)
    np.testing.assert_allclose(cr_t.curv.numpy(), np.asarray(cr_j.curv),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("target", [False, True])
def test_select_features(ref_ri, target):
    ri_j = jri.RangeImage(*(jnp.asarray(x) for x in ref_ri))
    ri_t = tri.RangeImage(*(_t(x) for x in ref_ri))
    f_j = jfeat.select_features(ri_j, jcurv.compute_curvature(ri_j, CFG),
                                CFG, target=target)
    f_t = tfeat.select_features(ri_t, tcurv.compute_curvature(ri_t, CFG),
                                CFG, target=target)
    assert np.asarray(f_j.edge_mask).sum() > 0
    assert np.asarray(f_j.planar_mask).sum() > 0
    for name in ("edge_mask", "planar_mask", "edge_ring", "planar_ring",
                 "edge_phase", "planar_phase"):
        np.testing.assert_array_equal(getattr(f_t, name).numpy(),
                                      np.asarray(getattr(f_j, name)), name)
    for name in ("edges", "planars"):
        np.testing.assert_allclose(getattr(f_t, name).numpy(),
                                   np.asarray(getattr(f_j, name)),
                                   atol=1e-5, err_msg=name)


# ----- the raw-scan front end (prebin_host=False) -------------------------

def _raw_range_images(scan, cfg, delta, enabled=True):
    """(reference, port) range images of one padded raw scan, as numpy."""
    pts, mask = pad_scan(scan, cfg.n_rings * cfg.n_azimuth)
    pj, sj = jdeskew.deskew(jnp.asarray(pts[:, :3]), jnp.asarray(delta),
                            az_start=cfg.az_start, enabled=enabled)
    ri_j = jri.build_range_image(pj, jnp.asarray(mask), sj, cfg)
    pt, st = tdeskew.deskew(_t(pts[:, :3]), _t(delta), az_start=cfg.az_start,
                            enabled=enabled)
    ri_t = tri.build_range_image(pt, _t(mask), st, cfg)
    return (jri.RangeImage(*(np.asarray(x) for x in ri_j)),
            jri.RangeImage(*(x.numpy() for x in ri_t)),
            (np.asarray(pj), np.asarray(sj), pt.numpy(), st.numpy(), mask))


@pytest.mark.parametrize("ring_mode", ["linear", "hdl64e"])
def test_deskew_and_build_range_image(scans, ring_mode):
    """The raw-scan path against JAX.  The deskewed points agree to two
    float32 ulps of the range (the backends' sin/cos differ in the last
    bit); ``valid`` must be identical, and so must the winner of every
    cell, apart from cells where a last-bit difference in a deskewed
    point moves its elevation or its 1 cm range bucket across a boundary:
    those are counted, and must stay under 0.1 % of the cells."""
    cfg = dataclasses.replace(CFG, ring_mode=ring_mode,
                              az_start=float(np.pi) if ring_mode == "hdl64e"
                              else 0.0)
    ref, got, (pj, sj, pt, st, mask) = _raw_range_images(scans[1], cfg,
                                                         DELTA)
    # The phase is atan2 / 2 pi: XLA's float32 atan2 and the port's
    # (float64, rounded once) differ by one ulp on some points.
    np.testing.assert_allclose(st[mask], sj[mask], atol=1.2e-7)
    np.testing.assert_allclose(pt[mask], pj[mask], atol=1e-5, rtol=2e-7)
    assert ref.valid.mean() > 0.3
    flipped = int((got.valid != ref.valid).sum())
    both = got.valid & ref.valid
    other_winner = int((np.abs(got.phase - ref.phase) > 1e-6)[both].sum())
    print(f"{ring_mode}: {flipped} cells flipped, {other_winner} other "
          f"winners of {int(ref.valid.sum())}")
    assert flipped + other_winner <= 1e-3 * ref.valid.size
    same = both & (np.abs(got.phase - ref.phase) <= 1e-6)
    np.testing.assert_allclose(got.xyz[same], ref.xyz[same], atol=1e-5,
                               rtol=2e-7)
    np.testing.assert_allclose(got.rng[same], ref.rng[same], atol=1e-5,
                               rtol=2e-7)


@pytest.mark.parametrize("ring_mode", ["linear", "hdl64e"])
def test_build_range_image_without_motion_is_exact(scans, ring_mode):
    """With the deskew off no point moves: the two packages must then pick
    the same winner in every cell (points and ranges bitwise; the phase to
    one ulp of atan2), and both agree with the pre-binned path
    (``range_image_from_grid(bin_scan_host(scan))``), except where the
    host's float64 elevation and the device's float32 one put a point
    into neighbouring rings (counted; under 0.5 % of the cells)."""
    cfg = dataclasses.replace(CFG, ring_mode=ring_mode)
    zero = np.zeros(6, np.float32)
    ref, got, _ = _raw_range_images(scans[0], cfg, zero, enabled=False)
    for name in ("valid", "xyz", "rng"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name))
    np.testing.assert_allclose(got.phase, ref.phase, atol=1.2e-7)
    g, v = tri.bin_scan_host(scans[0], cfg)
    pre = tri.range_image_from_grid(_t(g), _t(v), _t(zero), cfg,
                                    enabled=False)
    differ = (pre.valid.numpy() != got.valid) | (
        (pre.rng.numpy() != got.rng) & got.valid)
    print(f"{ring_mode}: {int(differ.sum())} of {differ.size} cells differ "
          "between host pre-binning and the device scatter")
    assert differ.mean() < 5e-3
    keep = ~differ
    np.testing.assert_array_equal(pre.xyz.numpy()[keep], got.xyz[keep])
    np.testing.assert_array_equal(pre.rng.numpy()[keep], got.rng[keep])


def test_build_range_image_first_beam_wins_ties():
    """hdl64e ring assignment keeps the first of two equally near beams,
    and a cell's winner is the nearest return (lowest index on a tie)."""
    cfg = dataclasses.replace(CFG, ring_mode="hdl64e", n_rings=64,
                              n_azimuth=64)
    beams = tri.hdl64e_beam_elevations(64).astype(np.float32)
    mid = np.float32(0.5) * (beams[3] + beams[4])  # between rings 3 and 4
    el = np.array([mid, beams[10], beams[10], beams[10]], np.float32)
    r = np.array([20.0, 30.0, 10.0, 10.0], np.float32)
    pts = np.stack([r * np.cos(el), np.zeros(4, np.float32),
                    r * np.sin(el)], 1).astype(np.float32)
    phase = np.full(4, 0.5, np.float32)
    mask = np.ones(4, bool)
    ri_j = jri.build_range_image(jnp.asarray(pts), jnp.asarray(mask),
                                 jnp.asarray(phase), cfg)
    ri_t = tri.build_range_image(_t(pts), _t(mask), _t(phase), cfg)
    for a, b in zip(ri_t, ri_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    valid = ri_t.valid.numpy()
    assert valid.sum() == 2 and valid[10, 32]
    np.testing.assert_array_equal(ri_t.xyz.numpy()[10, 32], pts[2])
