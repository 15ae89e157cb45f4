"""Port parity of ``pipeline/smoother.py`` and its two behavioural tests.

Shapes are those of the reference's own smoother test: 16 x 512 raw scans,
12 frames, window 4.  Both packages start from the same forward poses (the
reference's), so one ``refine_poses`` pass is compared frame by frame:
1 cm / 0.05 deg, the single-step gate of the odometry tests, and the same
frames rejected by the gates.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from velo_tpu import config as jconfig
from velo_tpu.evaluation import kitti_metric
from velo_tpu.io import fixtures, kitti
from velo_tpu.pipeline import odometry as jodo
from velo_tpu.pipeline import smoother as jsm
from velo_tpu_torch.pipeline import odometry as todo
from velo_tpu_torch.pipeline import smoother as tsm
from test_torch_odometry import _pose_diff

torch.set_num_threads(1)

FRAMES, RINGS, AZ, WINDOW = 12, 16, 512, 4
CFG = jconfig.VeloConfig(
    lidar=jconfig.LidarConfig(n_rings=RINGS, n_azimuth=AZ),
    map=jconfig.MapConfig(edge_capacity=8192, planar_capacity=16384),
    n_max_points=RINGS * AZ, use_vision=False, use_map=True)


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.fixture(scope="module")
def seq():
    fx = fixtures.make_fixture(n_frames=FRAMES, n_rings=RINGS, n_azimuth=AZ,
                               with_images=False, speed=8.0, seed=3)
    padded = [kitti.pad_scan(s, CFG.n_max_points) for s in fx.scans]
    scans = np.stack([p[0] for p in padded])
    masks = np.stack([p[1] for p in padded])
    run = jax.jit(lambda c, s, m: jodo.run_scan(c, s, m, CFG))
    _, out = run(jodo.init_carry(CFG), jnp.asarray(scans),
                 jnp.asarray(masks))
    return scans, masks, np.asarray(out.T_w), fx


@pytest.fixture(scope="module")
def ref_feats(seq):
    scans, masks, fwd, _ = seq
    return jsm.collect_features(jnp.asarray(scans), jnp.asarray(masks),
                                jnp.asarray(fwd), CFG)


def test_realized_deltas(seq):
    fwd = seq[2]
    dj = np.asarray(jsm.realized_deltas(jnp.asarray(fwd)))
    dt = tsm.realized_deltas(_t(fwd)).numpy()
    assert dt.shape == (FRAMES, 6)
    np.testing.assert_array_equal(dt[0], dt[1])
    # The log of a relative pose of ~0.8 m: 1e-6 covers the float32
    # rounding of the two packages' matrix products and arccos.
    np.testing.assert_allclose(dt, dj, atol=1e-6)


def _rows(pts):
    """The points of one frame as a set, on a 0.1 mm lattice."""
    return set(map(tuple, np.round(pts * 1e4).astype(np.int64)))


def test_collect_features(seq, ref_feats):
    """The same features frame by frame, as sets of points to 0.1 mm.
    Against the reference's jitted ``collect_features`` the edges agree
    completely, but 5-8 % of a frame's planar picks differ: they are the
    lowest curvatures of the simulator's exactly flat ground and walls,
    where last-bit differences in the deskewed points reorder runs of
    near-zero values.  XLA's fusion inside ``lax.scan`` is such a
    difference: the reference's own front end run op by op shares with its
    jitted scan about as much as the port does (measured on frames 1 and
    5: 93-98 %).  Every such pick lies on the same plane;
    ``test_refine_poses_one_pass`` bounds what it costs."""
    scans, masks, fwd, _ = seq
    ft = tsm.collect_features(_t(scans), _t(masks), _t(fwd), CFG)
    for name in tsm.FrameFeatures._fields:
        a = getattr(ft, name).numpy()
        b = np.asarray(getattr(ref_feats, name))
        assert a.shape == b.shape and a.shape[0] == FRAMES, name
        if name.endswith("mask"):
            assert b.any(axis=1).all(), name
            # Picks per frame: equal for the edges, within 4 % for planars.
            na, nb = a.sum(axis=1), b.sum(axis=1)
            tol = 0.04 if "planar" in name else 0.0
            assert (np.abs(na - nb) <= tol * nb).all(), (name, na, nb)
        else:
            common = [len(_rows(a[f]) & _rows(b[f])) / len(_rows(b[f]))
                      for f in range(FRAMES)]
            print(f"{name}: {min(common):.4f} of a frame's points common")
            assert min(common) >= (0.9 if "planar" in name else 0.99), (
                name, common)


def test_refine_poses_one_pass(seq, ref_feats):
    """One Jacobi pass from the same forward poses and the same features
    (the reference's, so that this compares the sweep and not the front
    end): every frame within 1 cm / 0.05 deg, frame 0 fixed, and the same
    frames rejected by the gates (a rejected frame keeps its pose up to
    the gauge fix)."""
    scans, masks, fwd, _ = seq
    rj = np.asarray(jsm.refine_poses(jnp.asarray(fwd), ref_feats, CFG,
                                     window=WINDOW, passes=1))
    feats_t = tsm.FrameFeatures(*(_t(x) for x in ref_feats))
    rt = tsm.refine_poses(_t(fwd), feats_t, CFG, window=WINDOW,
                          passes=1).numpy()
    assert rt.shape == (FRAMES, 4, 4) and np.isfinite(rt).all()
    np.testing.assert_allclose(rt[0], fwd[0], atol=1e-5)
    worst = (0.0, 0.0)
    for f in range(FRAMES):
        dt, dr = _pose_diff(rt[f], rj[f])
        print(f"frame {f}: {dt:.5f} m, {dr:.5f} deg")
        worst = (max(worst[0], dt), max(worst[1], dr))
    assert worst[0] < 0.01 and worst[1] < 0.05, worst

    def moved(ref):
        # Relative to frame 0's correction, which the gauge fix applies to
        # every frame: a rejected frame keeps its forward relative pose.
        return np.array([_pose_diff(np.linalg.inv(fwd[0]) @ fwd[f],
                                    np.linalg.inv(ref[0]) @ ref[f])[0] > 1e-6
                         for f in range(FRAMES)])
    assert moved(rj).any()
    # Same poses entering, so the same refinement decisions.
    jumps_j = np.array([_pose_diff(fwd[f], rj[f])[0] for f in range(FRAMES)])
    jumps_t = np.array([_pose_diff(fwd[f], rt[f])[0] for f in range(FRAMES)])
    np.testing.assert_allclose(jumps_t, jumps_j, atol=0.01)


def test_refine_poses_is_a_jacobi_sweep(seq, ref_feats):
    """Every frame solves against the same pose snapshot: frame 3's result
    equals a solve done by hand against the poses that entered the pass (a
    loop that updated ``poses`` as it went would have shown frame 3 the
    refined frames 1 and 2), and the input is left as it was."""
    from velo_tpu_torch.geom import se3
    from velo_tpu_torch.solve import icp

    _, _, fwd, _ = seq
    w = 2
    ft = tsm.FrameFeatures(*(_t(x)[:6] for x in ref_feats))
    poses = _t(fwd[:6])
    before = poses.clone()
    out = tsm.refine_poses(poses, ft, CFG, window=w, passes=1, alpha=1.0)
    torch.testing.assert_close(poses, before, rtol=0, atol=0)

    def by_hand(i):
        def window(stack, mask):
            # The layout of the pass: 2w+1 slots, frames outside the
            # sequence as masked zeros, the centre frame masked.
            pts, msk = [], []
            for j in range(i - w, i + w + 1):
                inside = 0 <= j < 6
                pts.append(se3.apply(poses[j], stack[j]) if inside
                           else torch.zeros_like(stack[0]))
                msk.append(mask[j] if inside and j != i
                           else torch.zeros_like(mask[0]))
            return icp.make_targets(torch.cat(pts), torch.cat(msk))
        T_new, diag = icp.solve_scan_to_map(
            ft.q_edges[i], ft.q_edge_mask[i], ft.q_planars[i],
            ft.q_planar_mask[i], window(ft.t_edges, ft.t_edge_mask),
            window(ft.t_planars, ft.t_planar_mask), poses[i], CFG.solver)
        assert not bool(diag.degenerate)
        return T_new.numpy().astype(np.float64)

    # out[i] = poses[0] new[0]^-1 new[i] (the gauge fix); alpha = 1 and a
    # correction inside the gates make new[i] the solve's own result.
    # 1e-5 m covers the float64 products here against float32 there.
    expect = fwd[0].astype(np.float64) @ np.linalg.inv(by_hand(0)) \
        @ by_hand(3)
    dt, dr = _pose_diff(out[3].numpy(), expect)
    print(f"frame 3 against the snapshot solve: {dt:.6f} m, {dr:.6f} deg")
    assert dt < 1e-5 and dr < 1e-4


def _ate(poses_velo, fx):
    cam = todo.velo_to_cam_trajectory(poses_velo, fx.T_cam_velo)
    return kitti_metric.ate_rmse(cam, fx.gt_poses_cam[:len(cam)])


def test_smoother_not_worse_and_finite(seq):
    scans, masks, fwd, fx = seq
    ref = tsm.smooth_trajectory(scans, masks, fwd, CFG, window=WINDOW,
                                passes=2, device="cpu")
    assert isinstance(ref, np.ndarray) and np.isfinite(ref).all()
    # Gauge pinned: frame 0 unchanged.
    np.testing.assert_allclose(ref[0], fwd[0], atol=1e-5)
    ate_fwd, ate_ref = _ate(fwd, fx), _ate(ref, fx)
    assert ate_ref <= ate_fwd * 1.25 + 0.01, (ate_fwd, ate_ref)


def test_smoother_recovers_injected_pose_error(seq):
    """Perturb one mid-trajectory pose; the window solves pull it back."""
    scans, masks, fwd, fx = seq
    bad = fwd.copy()
    k = FRAMES // 2
    T_err = np.eye(4)
    T_err[:3, 3] = [0.25, 0.15, 0.0]
    bad[k] = bad[k] @ T_err
    err_before = np.linalg.norm((np.linalg.inv(fwd[k]) @ bad[k])[:3, 3])
    ref = tsm.smooth_trajectory(scans, masks, bad, CFG, window=WINDOW,
                                passes=3, device="cpu")
    err_after = np.linalg.norm((np.linalg.inv(fwd[k]) @ ref[k])[:3, 3])
    assert err_before > 0.29
    # Most of the injected 29 cm error must be recovered.
    assert err_after < 0.4 * err_before, (err_before, err_after)


def test_smoother_defaults_to_the_card(monkeypatch, seq):
    scans, masks, fwd, _ = seq
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsm.smooth_trajectory(scans, masks, fwd, CFG)
