"""Port parity of the visual front end: pyramid, Scharr gradients,
bilinear sampling, Shi-Tomasi corners, the track table and LiDAR depth
association.

The same numpy arrays go through ``velo_tpu`` (JAX, CPU) and
``velo_tpu_torch``.  Picks, masks and table contents must be equal.
Float tolerances: 1e-6 on [0, 1] images (element-wise float32 in the same
order; XLA may contract a multiply-add); 1e-4 m / 1e-3 px on projected
LiDAR geometry (the port rounds its projections from float64).
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
from velo_tpu.vision import corners as jcorners
from velo_tpu.vision import depth_assoc as jda
from velo_tpu.vision import pyramid as jpyr
from velo_tpu.vision import tracks as jtracks
from velo_tpu_torch import config as tconfig
from velo_tpu_torch.geom import camera as tcam
from velo_tpu_torch.lidar import rangeimage as tri
from velo_tpu_torch.vision import corners as tcorners
from velo_tpu_torch.vision import depth_assoc as tda
from velo_tpu_torch.vision import pyramid as tpyr
from velo_tpu_torch.vision import tracks as ttracks

torch.set_num_threads(1)

H, W = 128, 384
VC_J = jconfig.tiny_test_config().vision
VC_T = tconfig.tiny_test_config().vision


def _t(x):
    return torch.tensor(np.asarray(x))


def _j(x):
    return jnp.asarray(np.asarray(x))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _cams(P, T_cam_velo):
    return (jcam.Camera(P=_j(P.astype(np.float32)),
                        T_cam_velo=_j(T_cam_velo.astype(np.float32)),
                        width=W, height=H),
            tcam.from_numpy(P, T_cam_velo, W, H, "cpu"))


@pytest.fixture(scope="module")
def scene():
    """One fixture frame: image, range image (from the JAX front end, fed
    to both packages), calibration."""
    cfg = jconfig.tiny_test_config()
    fx = fixtures.make_fixture(n_frames=1, n_rings=cfg.lidar.n_rings,
                               n_azimuth=cfg.lidar.n_azimuth, height=H,
                               width=W, seed=3)
    g, v = jri.bin_scan_host(fx.scans[0], cfg.lidar)
    ri = jri.range_image_from_grid(_j(g), _j(v), jnp.zeros(6), cfg.lidar)
    return dict(img=fx.images[0], ri=[np.asarray(x) for x in ri], P=fx.P,
                T=fx.T_cam_velo)


def test_pyramid_and_scharr(scene):
    rng = np.random.default_rng(0)
    for img in (scene["img"], rng.random((96, 200)).astype(np.float32)):
        pj = jpyr.build_pyramid(_j(img), 4)
        pt = tpyr.build_pyramid(_t(img), 4)
        assert [tuple(x.shape) for x in pt] == [x.shape for x in pj]
        for a, b in zip(pt, pj):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
            for ga, gb in zip(tpyr.scharr_gradients(_t(np.asarray(b))),
                              jpyr.scharr_gradients(b)):
                np.testing.assert_allclose(ga.numpy(), np.asarray(gb),
                                           atol=1e-6)


def test_bilinear_sample_and_patch_offsets(scene):
    rng = np.random.default_rng(1)
    xy = np.stack([rng.uniform(-3, W + 2, 4096),
                   rng.uniform(-3, H + 2, 4096)], -1).astype(np.float32)
    vj, ij = jpyr.bilinear_sample(_j(scene["img"]), _j(xy))
    vt, it = tpyr.bilinear_sample(_t(scene["img"]), _t(xy))
    assert (~it.numpy()).sum() > 50
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=1e-6)
    np.testing.assert_array_equal(tpyr.patch_offsets(7).numpy(),
                                  np.asarray(jpyr.patch_offsets(7)))


def test_corner_response_and_detect(scene):
    img = scene["img"]
    rj = np.asarray(jcorners.shi_tomasi_response(_j(img)))
    rt = tcorners.shi_tomasi_response(_t(img)).numpy()
    np.testing.assert_allclose(rt, rj, atol=1e-6)
    cj = jcorners.detect(_j(img), VC_J)
    ct = tcorners.detect(_t(img), VC_T)
    assert np.asarray(cj.valid).sum() > 100
    np.testing.assert_array_equal(ct.valid.numpy(), np.asarray(cj.valid))
    np.testing.assert_array_equal(ct.uv.numpy(), np.asarray(cj.uv))
    np.testing.assert_allclose(ct.response.numpy(), np.asarray(cj.response),
                               atol=1e-6)


def test_detect_takes_the_first_of_tied_corners():
    """A checkerboard of period 8 repeats the same response within every
    16 x 16 bucket: both packages must pick the first maximum (row-major),
    as ``np.argmax`` does."""
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    img = (((yy // 4) + (xx // 4)) % 2).astype(np.float32)
    cj = jcorners.detect(_j(img), VC_J)
    ct = tcorners.detect(_t(img), VC_T)
    np.testing.assert_array_equal(ct.uv.numpy(), np.asarray(cj.uv))
    resp = tcorners.shi_tomasi_response(_t(img)).numpy()
    resp[:8], resp[-8:], resp[:, :8], resp[:, -8:] = -1, -1, -1, -1
    bh, bw = H // VC_T.grid_rows, W // VC_T.grid_cols
    blocks = resp.reshape(VC_T.grid_rows, bh, VC_T.grid_cols, bw)
    blocks = blocks.transpose(0, 2, 1, 3).reshape(-1, bh * bw)
    n_max = (blocks == blocks.max(1, keepdims=True)).sum(1)
    assert (n_max > 1).mean() > 0.9  # the ties are real
    first = np.argmax(blocks, axis=1)
    cell = np.arange(len(first))
    uv = np.stack([(cell % VC_T.grid_cols) * bw + first % bw,
                   (cell // VC_T.grid_cols) * bh + first // bw], -1)
    np.testing.assert_array_equal(ct.uv.numpy(), uv.astype(np.float32))


def test_track_table_replenish_and_after_tracking(scene):
    cj = jcorners.detect(_j(scene["img"]), VC_J)
    ct = tcorners.Corners(*(_t(x) for x in cj))
    tj, tt = jtracks.empty_tracks(VC_J), ttracks.empty_tracks(VC_T, "cpu")
    rng = np.random.default_rng(2)
    for it in range(4):
        tj = jtracks.replenish(tj, cj, VC_J)
        tt = ttracks.replenish(tt, ct, VC_T)
        for a, b in zip(tt, tj):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        # Fail a random part of the tracks and move the survivors.
        ok = rng.random(VC_T.k_tracks) > 0.3 + 0.1 * it
        new_uv = (np.asarray(tj.uv)
                  + rng.normal(0, 3, (VC_T.k_tracks, 2))).astype(np.float32)
        tj = jtracks.after_tracking(tj, _j(new_uv), _j(ok))
        tt = ttracks.after_tracking(tt, _t(new_uv), _t(ok))
        for a, b in zip(tt, tj):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert 0 < int(tt.active.sum()) < VC_T.k_tracks


def test_depth_grid_and_association(scene):
    camj, camt = _cams(scene["P"], scene["T"])
    rij = jri.RangeImage(*(_j(x) for x in scene["ri"]))
    rit = tri.RangeImage(*(_t(x) for x in scene["ri"]))
    gj = jda.build_depth_grid_from_ri(rij, camj, VC_J)
    gt = tda.build_depth_grid_from_ri(rit, camt, VC_T)
    assert (gt.rows, gt.cols) == (gj.rows, gj.cols)
    valid = np.asarray(gj.valid)
    assert valid.sum() > 300
    np.testing.assert_array_equal(gt.valid.numpy(), valid)
    np.testing.assert_allclose(gt.xyz.numpy(), np.asarray(gj.xyz), atol=1e-4)
    np.testing.assert_allclose(gt.uv.numpy(), np.asarray(gj.uv), atol=1e-3)

    # Query at the corners of the frame and at jittered grid winners.
    cj = jcorners.detect(_j(scene["img"]), VC_J)
    rng = np.random.default_rng(4)
    win = np.asarray(gj.uv)[valid][::3]
    uv = np.concatenate([np.asarray(cj.uv),
                         win + rng.normal(0, 1.5, win.shape)]).astype(
                             np.float32)
    mask = np.concatenate([np.asarray(cj.valid), np.ones(len(win), bool)])
    rj = jda.associate(gj, _j(uv), _j(mask), camj, VC_J)
    rt = tda.associate(gt, _t(uv), _t(mask), camt, VC_T)
    ok = np.asarray(rj.ok)
    assert 100 < ok.sum() < len(ok)
    np.testing.assert_array_equal(rt.ok.numpy(), ok)
    np.testing.assert_allclose(rt.xyz_cam.numpy(), np.asarray(rj.xyz_cam),
                               atol=1e-4)
    np.testing.assert_allclose(rt.depth.numpy(), np.asarray(rj.depth),
                               atol=1e-4)
    np.testing.assert_allclose(rt.grad.numpy(), np.asarray(rj.grad),
                               atol=1e-5)


def _hand_grid(mod, cfg, P, entries):
    """A DepthGrid holding exactly the given (u, v, z) winners."""
    c = cfg.depth_grid_cell
    rows, cols = cfg.height // c, cfg.width // c
    xyz = np.zeros((rows * cols, 3), np.float32)
    uv = np.full((rows * cols, 2), -1e4, np.float32)
    valid = np.zeros((rows * cols,), bool)
    for u, v, z in entries:
        idx = (int(v) // c) * cols + (int(u) // c)
        xyz[idx] = ((u - P[0, 2]) / P[0, 0] * z, (v - P[1, 2]) / P[1, 1] * z,
                    z)
        uv[idx] = (u, v)
        valid[idx] = True
    conv = _j if mod is jda else _t
    return mod.DepthGrid(xyz=conv(xyz), uv=conv(uv), valid=conv(valid),
                         rows=rows, cols=cols)


def _ground(P, u, z):
    return (u, P[1, 2] + P[1, 1] * 1.7 / z, z)


_LOOSE = dict(max_depth_grad=1e9, max_depth_spread=1e9,
              min_plane_incidence=0.0, depth_range_slack=1e9)


@pytest.mark.parametrize("case", [
    "occlusion", "occlusion_loose", "receding", "grazing", "grazing_loose",
    "too_far", "spread"])
def test_association_gates(case):
    """The gate cases of ``tests/unit/test_vision.py`` (occlusion edge,
    receding plane, grazing ground, each with and without its gate) plus a
    query past the pixel bound and one across a depth step."""
    P, T = fixtures.default_calib(H, W)
    camj, camt = _cams(P, T)
    q = (99.0, 64.0)
    if case.startswith("occlusion"):
        pts = [(94.0, 68.0, 10.0), (98.0, 60.0, 10.0), (102.0, 68.0, 10.0),
               (99.0, 71.0, 30.0)]
        over = {"max_plane_outlier": 1e9} if case.endswith("loose") else {}
    elif case == "receding":
        pts = [(u, v, 10.0 + 0.1 * (u - 98.0)) for u, v in
               ((94.0, 68.0), (98.0, 60.0), (102.0, 68.0), (105.0, 64.0))]
        over = {}
    elif case.startswith("grazing"):
        pts = [_ground(P, 94.0, 25.0), _ground(P, 98.0, 26.0),
               _ground(P, 102.0, 27.0), _ground(P, 105.0, 26.5)]
        q = _ground(P, 99.0, 26.2)[:2]
        over = _LOOSE if case.endswith("loose") else {}
    elif case == "too_far":
        pts = [(94.0, 68.0, 10.0), (98.0, 60.0, 10.0), (102.0, 68.0, 10.0)]
        q = (112.0, 64.0)
        over = {}
    else:
        pts = [(94.0, 68.0, 10.0), (98.0, 60.0, 12.0), (102.0, 68.0, 10.0)]
        over = {}
    cj = dataclasses.replace(VC_J, **over)
    ct = dataclasses.replace(VC_T, **over)
    P32 = P.astype(np.float32)
    rj = jda.associate(_hand_grid(jda, cj, P32, pts), _j([q]), _j([True]),
                       camj, cj)
    rt = tda.associate(_hand_grid(tda, ct, P32, pts), _t(np.float32([q])),
                       _t([True]), camt, ct)
    expect_ok = case in ("occlusion_loose", "receding", "grazing_loose")
    assert bool(rj.ok[0]) == expect_ok
    assert bool(rt.ok[0]) == expect_ok
    np.testing.assert_allclose(rt.depth.numpy(), np.asarray(rj.depth),
                               atol=1e-4)
    np.testing.assert_allclose(rt.grad.numpy(), np.asarray(rj.grad),
                               atol=1e-5)
