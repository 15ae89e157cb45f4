"""Port parity: correspondence search, local map, fits, the LM system
(LiDAR-only and fused with visual tracks), the visual residuals and the
scan-to-scan / scan-to-map solves.

Solver inputs come from a synthetic box scene (ground, four walls, six
vertical edge poles) sampled with 1 cm noise, so every PCA fit is well
conditioned: parity here is about the arithmetic, not about eigenvalue
gates deciding on last-bit rounding (see test_torch_odometry for that).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from velo_tpu import config as jconfig
from velo_tpu.geom import se3 as jse3
from velo_tpu.io import fixtures
from velo_tpu.mapping import dense_nn as jnn
from velo_tpu.mapping import local_map as jlm
from velo_tpu.mapping import voxel_hash as jvh
from velo_tpu.solve import icp as jicp
from velo_tpu.solve import lm as jlmsolve
from velo_tpu.solve import residuals as jres
from velo_tpu_torch.geom import se3 as tse3
from velo_tpu_torch.mapping import dense_nn as tnn
from velo_tpu_torch.mapping import local_map as tlm
from velo_tpu_torch.mapping import voxel_hash as tvh
from velo_tpu_torch.solve import icp as ticp
from velo_tpu_torch.solve import lm as tlmsolve
from velo_tpu_torch.solve import residuals as tres

torch.set_num_threads(1)

SC = jconfig.SolverConfig()
XI_TRUE = np.array([0.6, -0.05, 0.02, 0.004, -0.003, 0.02], np.float32)


def _t(x):
    return torch.tensor(np.asarray(x))


def _j(x):
    return jnp.asarray(np.asarray(x))


def _planes(rng, n):
    """n points on the ground (z=-1.7) and four walls, 1 cm noise."""
    face = rng.integers(0, 5, n)
    u, v = rng.uniform(-1, 1, n), rng.uniform(0, 1, n)
    x = np.where(face == 0, 12 * u, np.where(face == 1, 9.0,
                 np.where(face == 2, -7.0, 12 * u)))
    y = np.where(face == 0, 10 * v * 2 - 10, np.where(face <= 2, 10 * u,
                 np.where(face == 3, 10.0, -8.0)))
    z = np.where(face == 0, -1.7, -1.7 + 4.0 * v)
    p = np.stack([x, y, z], 1)
    return (p + rng.normal(0, 0.01, p.shape)).astype(np.float32)


_POLES = np.array([[9, 10], [-7, 10], [9, -8], [-7, -8], [3, 4], [-2, -5]],
                  np.float64)


def _edges(rng, n):
    """n points on six vertical poles, with their laser ring (z level)."""
    pole = rng.integers(0, len(_POLES), n)
    ring = rng.integers(0, 40, n)
    z = -1.7 + 0.1 * ring + rng.normal(0, 0.01, n)
    xy = _POLES[pole] + rng.normal(0, 0.01, (n, 2))
    return np.concatenate([xy, z[:, None]], 1).astype(np.float32), ring


def _make_scene():
    rng = np.random.default_rng(21)
    et, ering = _edges(rng, 1536)
    pt = _planes(rng, 3072)
    etm = rng.random(1536) > 0.1
    ptm = rng.random(3072) > 0.1
    # Query features: fresh samples, expressed in the current frame.
    T_inv = np.linalg.inv(np.asarray(jse3.exp(_j(XI_TRUE)), np.float64))
    eq, _ = _edges(rng, 512)
    pq = _planes(rng, 1024)
    eq = (eq @ T_inv[:3, :3].T + T_inv[:3, 3]).astype(np.float32)
    pq = (pq @ T_inv[:3, :3].T + T_inv[:3, 3]).astype(np.float32)
    eqm = rng.random(512) > 0.05
    pqm = rng.random(1024) > 0.05
    eq[~eqm] = 0.0
    pq[~pqm] = 0.0
    return dict(et=et, ering=ering.astype(np.int32), etm=etm, pt=pt,
                ptm=ptm, eq=eq, eqm=eqm, pq=pq, pqm=pqm)


@pytest.fixture(scope="module")
def scene():
    return _make_scene()


def _targets(sc, mod, conv, kind):
    if kind == "edge":
        return mod.make_targets(conv(sc["et"]), conv(sc["etm"]),
                                payload=conv(sc["ering"][:, None]))
    return mod.make_targets(conv(sc["pt"]), conv(sc["ptm"]))


@pytest.mark.parametrize("approx", [False, True])
def test_knn(scene, approx):
    args = dict(k=16, max_dist=3.0, approx=approx)
    ij, dj, vj = (np.asarray(x) for x in jnn.knn(
        _targets(scene, jnn, _j, "planar"), _j(scene["pq"]),
        _j(scene["pqm"]), **args))
    it, dt, vt = (x.numpy() for x in tnn.knn(
        _targets(scene, tnn, _t, "planar"), _t(scene["pq"]),
        _t(scene["pqm"]), **args))
    assert it.dtype == np.int32
    np.testing.assert_array_equal(vt, vj)
    # Distances up to 3 m from d2 = |q|^2 - 2q.t + |t|^2 with |.|^2 up to
    # ~250 m^2: float32 cancellation leaves ~1e-3 m near d = 0.1 m.
    np.testing.assert_allclose(dt[vj], dj[vj], atol=2e-3)
    assert (it == ij)[vj].mean() >= 0.999


def test_build_candidates(scene):
    T0 = XI_TRUE * 0.9
    cj = jicp.build_candidates(_targets(scene, jicp, _j, "edge"),
                               _j(scene["eq"]), _j(scene["eqm"]),
                               jse3.exp(_j(T0)), SC)
    ct = ticp.build_candidates(_targets(scene, ticp, _t, "edge"),
                               _t(scene["eq"]), _t(scene["eqm"]),
                               tse3.exp(_t(T0)), SC)
    ok = np.asarray(cj.ok)
    np.testing.assert_array_equal(ct.ok.numpy(), ok)
    # Every query keeps the same candidate set (points with their ring).
    rows_j = np.concatenate([np.asarray(cj.pts),
                             np.asarray(cj.payload, np.float32)], -1)
    rows_t = np.concatenate([ct.pts.numpy(),
                             ct.payload.numpy().astype(np.float32)], -1)
    for i in range(len(ok)):
        assert sorted(map(tuple, rows_t[i][ok[i]])) == \
            sorted(map(tuple, rows_j[i][ok[i]])), i
    # Their order within the cache may differ where two candidates' d2 tie
    # to float32 rounding (dist_topk sums s in another order than XLA's
    # multiply-add chain; points on one pole sit at near-equal distances).
    # The outer iterations re-rank the cache by a fresh d2, so order is
    # immaterial.
    same = (rows_t == rows_j).all(-1)
    assert same[ok].mean() >= 0.98


def test_voxel_downsample_and_local_map():
    rng = np.random.default_rng(5)
    pts = rng.uniform(-20, 20, (8192, 3)).astype(np.float32)
    pts[4096:] = pts[:4096] + rng.normal(0, 0.05, (4096, 3)).astype(
        np.float32)  # duplicates in many voxels
    mask = rng.random(8192) > 0.2
    center = np.array([1.5, -2.0, 0.3], np.float32)
    m_j = np.asarray(jvh.voxel_downsample(_j(pts), _j(mask), 0.4,
                                          center=_j(center)))
    m_t = tvh.voxel_downsample(_t(pts), _t(mask), 0.4,
                               center=_t(center)).numpy()
    assert 0 < m_j.sum() < mask.sum()
    np.testing.assert_array_equal(m_t, m_j)

    # Ring buffer: three inserts wrap the cursor, then maintain.
    mj, mt = jlm.empty_map(4096), tlm.empty_map(4096)
    for i in range(3):
        new = rng.uniform(-30, 30, (1536, 3)).astype(np.float32)
        nm = rng.random(1536) > 0.3
        mj = jlm.insert(mj, _j(new), _j(nm))
        mt = tlm.insert(mt, _t(new), _t(nm))
        for a, b in zip(mt, mj):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    mj = jlm.maintain(mj, _j(center), 2.0, 25.0)
    mt = tlm.maintain(mt, _t(center), 2.0, 25.0)
    for a, b in zip(mt, mj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_fit_line_and_plane():
    rng = np.random.default_rng(8)
    # 2048 neighbour sets of 5: noisy lines and noisy planes.
    base = rng.uniform(-20, 20, (2048, 1, 3))
    d1 = rng.normal(size=(2048, 1, 3))
    d2 = rng.normal(size=(2048, 1, 3))
    s = rng.uniform(-0.5, 0.5, (2048, 5, 1))
    line = base + s * d1 + rng.normal(0, 0.01, (2048, 5, 3))
    plane = base + s * d1 + rng.uniform(-0.5, 0.5, (2048, 5, 1)) * d2 \
        + rng.normal(0, 0.01, (2048, 5, 3))
    mask = rng.random((2048, 5)) > 0.1
    for fit_j, fit_t, pts in ((jres.fit_line_eig, tres.fit_line_eig, line),
                              (jres.fit_plane_eig, tres.fit_plane_eig,
                               plane)):
        pts = pts.astype(np.float32)
        out_j = [np.asarray(x) for x in fit_j(_j(pts), _j(mask))]
        out_t = [x.numpy() for x in fit_t(_t(pts), _t(mask))]
        ok = out_j[2]
        assert ok.mean() > 0.5
        np.testing.assert_array_equal(out_t[2], ok)
        # Direction / normal up to sign; a plane's offset follows it.  Over
        # well-conditioned fits (ok) they agree to 1e-4; the offset, being
        # n . mu with |mu| up to 35 m, to 1e-3 m.
        if fit_j is jres.fit_line_eig:
            sign = np.sign(np.sum(out_t[1] * out_j[1], -1))[:, None]
            np.testing.assert_allclose(out_t[0], out_j[0], atol=1e-5)
            np.testing.assert_allclose((out_t[1] * sign)[ok], out_j[1][ok],
                                       atol=1e-4)
        else:
            sign = np.sign(np.sum(out_t[0] * out_j[0], -1))
            np.testing.assert_allclose((out_t[0] * sign[:, None])[ok],
                                       out_j[0][ok], atol=1e-4)
            np.testing.assert_allclose((out_t[1] * sign)[ok], out_j[1][ok],
                                       atol=1e-3)
        # Quality is 1 - 3*lam_small/lam_mid.  Near a double root the
        # closed form's arccos keeps only ~sqrt(eps) ~ 3e-4 of relative
        # precision, so the small eigenvalue (and the ratio) can move by
        # ~1e-3 between backends.
        np.testing.assert_allclose(out_t[3], out_j[3], atol=5e-3)


def _tracks():
    """Visual tracks of the fused solve: landmarks in front of the camera
    in the previous velodyne frame, their previous pixels, and noisy
    current observations at the true motion; 60 % carry depth."""
    rng = np.random.default_rng(31)
    P, T_cv = fixtures.default_calib(128, 384)
    k = 128
    X = np.stack([rng.uniform(6, 35, k), rng.uniform(-8, 8, k),
                  rng.uniform(-1.5, 3, k)], -1)
    T_true = np.asarray(jse3.exp(_j(XI_TRUE)), np.float64)

    def pix(Xv):
        Xc = Xv @ T_cv[:3, :3].T + T_cv[:3, 3]
        x = Xc @ P[:, :3].T + P[:, 3]
        return x[:, :2] / x[:, 2:3]

    X_cur = (X - T_true[:3, 3]) @ T_true[:3, :3]  # T_true^-1 X
    obs = pix(X_cur) + rng.normal(0, 0.3, (k, 2))
    depth = rng.random(k) < 0.6
    return dict(X=X.astype(np.float32), uv_prev=pix(X).astype(np.float32),
                obs=obs.astype(np.float32), depth=depth,
                nodepth=~depth & (rng.random(k) < 0.9),
                w_lm=rng.uniform(0.3, 1, k).astype(np.float32),
                P=P.astype(np.float32), T_cv=T_cv.astype(np.float32))


def _vis(mod, conv, w_scale):
    tr = _tracks()
    return mod.VisData(xyz_prev_velo=conv(tr["X"]), obs_uv=conv(tr["obs"]),
                       mask=conv(tr["depth"]), P=conv(tr["P"]),
                       T_cam_velo=conv(tr["T_cv"]),
                       uv_prev=conv(tr["uv_prev"]),
                       mask_nodepth=conv(tr["nodepth"]), w_scale=w_scale,
                       w_lm=conv(tr["w_lm"]))


def _linearization(scene, mod, conv, se3mod, vis=None):
    """Correspondences of one outer iteration at T0, for either package."""
    T0 = se3mod.exp(conv(XI_TRUE * 0.9))
    ec = mod.build_candidates(_targets(scene, mod, conv, "edge"),
                              conv(scene["eq"]), conv(scene["eqm"]), T0, SC)
    pc = mod.build_candidates(_targets(scene, mod, conv, "planar"),
                              conv(scene["pq"]), conv(scene["pqm"]), T0, SC)
    eq, pq = mod._cand_query(ec, SC), mod._cand_query(pc, SC)
    a, b, e_ok = mod._edge_lines_2pt(
        eq, se3mod.apply(T0[None], conv(scene["eq"])[None])[0],
        conv(scene["eqm"]))
    n, d, p_ok, p_q = mod._planar_planes_fit(
        pq, se3mod.apply(T0[None], conv(scene["pq"])[None])[0],
        conv(scene["pqm"]), SC.map_knn)
    sys = mod.make_lidar_system(conv(scene["eq"]), conv(scene["eqm"]), a, b,
                                e_ok, conv(scene["pq"]), conv(scene["pqm"]),
                                n, d, p_ok, SC, vis=vis, planar_q=p_q)
    return T0, sys, (e_ok, p_ok)


@pytest.mark.parametrize("fused", [False, True])
def test_lidar_system_and_stage(scene, fused):
    """H, g and cost at one linearization, LiDAR-only and with the visual
    reprojection and epipolar blocks (fused)."""
    vj = _vis(jicp, _j, jnp.float32(0.75)) if fused else None
    vt = _vis(ticp, _t, torch.tensor(0.75)) if fused else None
    Tj, sys_j, okj = _linearization(scene, jicp, _j, jse3, vis=vj)
    Tt, sys_t, okt = _linearization(scene, ticp, _t, tse3, vis=vt)
    for a, b in zip(okt, okj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    prior_T = XI_TRUE * 0.8
    st_j = jicp._make_stage(SC, jse3.exp(_j(prior_T)), jnp.float32(1.0),
                            sys_j)
    st_t = ticp._make_stage(SC, tse3.exp(_t(prior_T)), torch.tensor(1.0),
                            sys_t)
    outs_j = [sys_j(Tj), st_j(Tj)[:3]]
    outs_t = [sys_t(Tt), st_t(Tt)[:3]]
    for oj, ot in zip(outs_j, outs_t):
        for a, b in zip(ot, oj):
            b = np.asarray(b)
            # rtol 1e-4: sums over ~1.5k float32 rows in another order;
            # atol 1e-5 of the largest entry covers near-zero off-diagonals.
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-4,
                                       atol=1e-5 * np.abs(b).max())


@pytest.mark.parametrize("iters", [1, 2, 3, 4])
def test_lm_solve_accept_sequence(scene, iters):
    Tj, sys_j, _ = _linearization(scene, jicp, _j, jse3)
    Tt, sys_t, _ = _linearization(scene, ticp, _t, tse3)
    prior_T = XI_TRUE * 0.8
    st_j = jicp._make_stage(SC, jse3.exp(_j(prior_T)), jnp.float32(1.0),
                            sys_j)
    st_t = ticp._make_stage(SC, tse3.exp(_t(prior_T)), torch.tensor(1.0),
                            sys_t)
    T_j, s_j = jlmsolve.lm_solve(None, Tj, SC, iters=iters, stage=st_j)
    T_t, s_t = tlmsolve.lm_solve(None, Tt, SC, iters=iters, stage=st_t)
    assert int(s_t.n_accept) == int(s_j.n_accept)
    assert bool(s_t.converged) == bool(s_j.converged)
    np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), atol=1e-5)
    # The classic (prior-free) path as well.
    T_j, s_j = jlmsolve.lm_solve(sys_j, Tj, SC, iters=iters)
    T_t, s_t = tlmsolve.lm_solve(sys_t, Tt, SC, iters=iters)
    assert int(s_t.n_accept) == int(s_j.n_accept)
    np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), atol=1e-5)


@pytest.mark.parametrize("which", ["scan_to_scan", "scan_to_map"])
def test_solves(scene, which):
    T0 = XI_TRUE * 0.9
    prior = XI_TRUE * 0.8

    def run(mod, conv, se3mod, scale):
        et = _targets(scene, mod, conv, "edge")
        pt = _targets(scene, mod, conv, "planar")
        args = (conv(scene["eq"]), conv(scene["eqm"]), conv(scene["pq"]),
                conv(scene["pqm"]), et, pt, se3mod.exp(conv(T0)), SC)
        kw = dict(prior_T=se3mod.exp(conv(prior)), prior_scale=scale)
        if which == "scan_to_scan":
            return mod.solve_scan_to_scan(*args, **kw)
        return mod.solve_scan_to_map(*args, **kw)

    T_j, d_j = run(jicp, _j, jse3, jnp.float32(1.0))
    T_t, d_t = run(ticp, _t, tse3, torch.tensor(1.0))
    np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), atol=1e-4)
    assert int(d_t.lm_accept) == int(d_j.lm_accept)
    assert bool(d_t.degenerate) == bool(d_j.degenerate)
    # A neighbour right at the 1 m correspondence gate can fall on either
    # side of it after a last-bit difference in the pose: counts agree to 1%.
    for f in ("n_edge", "n_planar"):
        assert abs(int(getattr(d_t, f)) - int(getattr(d_j, f))) \
            <= 0.01 * int(getattr(d_j, f)), f
    T_true = np.asarray(jse3.exp(_j(XI_TRUE)))
    assert np.abs(T_t.numpy() - T_true).max() < 0.02


# The solver variants the command line can select: ``--fast`` is
# prior_obs_impl="deferred_tail"; "deferred" and the degeneracy remap
# (degen_rel_min > 0) come through ``--set``.
_VARIANTS = {
    "deferred": dict(prior_obs_impl="deferred"),
    "deferred_tail": dict(prior_obs_impl="deferred_tail"),
    "degen": dict(degen_rel_min=0.01),
    # A gate between the eigenvalue ratios of this scene (0.15 | 0.23), so
    # that the projector really removes directions (0.01 keeps all six).
    # Only at the level of one lm_solve: a projected solve ends its first
    # outer iteration where the next steps gain ~1e-5 of the cost, and the
    # accept of such a step is decided by float32 rounding.
    "degen_strong": dict(degen_rel_min=0.19),
    "degen_deferred_tail": dict(prior_obs_impl="deferred_tail",
                                degen_rel_min=0.19),
}


@pytest.mark.parametrize("variant", list(_VARIANTS))
def test_lm_solve_variants(scene, variant):
    """lm_solve from one shared linearisation, routed as the outer loops
    route it: pose to 1e-5, the accept count equal."""
    import dataclasses
    sc = dataclasses.replace(SC, **_VARIANTS[variant])
    Tj, sys_j, _ = _linearization(scene, jicp, _j, jse3)
    Tt, sys_t, _ = _linearization(scene, ticp, _t, tse3)
    prior = XI_TRUE * 0.8

    def run(mod, lmmod, se3mod, conv, sys_np, T0, one):
        pT = se3mod.exp(conv(prior))
        deferred = mod._use_deferred(sc, pT)
        assert deferred == (sc.prior_obs_impl != "staged")
        if deferred and sc.prior_obs_impl == "deferred":
            # The full dynamic system: the prior inside, its basis from the
            # system's own Hessian.
            full = _linearization_full(scene, mod, conv, se3mod, sc, pT, one)
            return lmmod.lm_solve(full, T0, sc, deferred=True)
        stage = mod._make_stage(sc, pT, one, sys_np)
        return lmmod.lm_solve(None, T0, sc, stage=stage, deferred=deferred)

    T_j, s_j = run(jicp, jlmsolve, jse3, _j, sys_j, Tj, jnp.float32(1.0))
    T_t, s_t = run(ticp, tlmsolve, tse3, _t, sys_t, Tt, torch.tensor(1.0))
    assert int(s_t.n_accept) == int(s_j.n_accept)
    assert int(s_j.n_accept) > 0
    assert bool(s_t.converged) == bool(s_j.converged)
    np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), atol=1e-5)
    np.testing.assert_allclose(float(s_t.cost), float(s_j.cost), rtol=1e-4)


def _linearization_full(scene, mod, conv, se3mod, sc, prior_T, scale):
    """make_lidar_system with the prior inside, on the correspondences of
    :func:`_linearization`."""
    T0 = se3mod.exp(conv(XI_TRUE * 0.9))
    ec = mod.build_candidates(_targets(scene, mod, conv, "edge"),
                              conv(scene["eq"]), conv(scene["eqm"]), T0, sc)
    pc = mod.build_candidates(_targets(scene, mod, conv, "planar"),
                              conv(scene["pq"]), conv(scene["pqm"]), T0, sc)
    eq, pq = mod._cand_query(ec, sc), mod._cand_query(pc, sc)
    a, b, e_ok = mod._edge_lines_2pt(
        eq, se3mod.apply(T0[None], conv(scene["eq"])[None])[0],
        conv(scene["eqm"]))
    n, d, p_ok, p_q = mod._planar_planes_fit(
        pq, se3mod.apply(T0[None], conv(scene["pq"])[None])[0],
        conv(scene["pqm"]), sc.map_knn)
    return mod.make_lidar_system(
        conv(scene["eq"]), conv(scene["eqm"]), a, b, e_ok, conv(scene["pq"]),
        conv(scene["pqm"]), n, d, p_ok, sc, planar_q=p_q, prior_T=prior_T,
        prior_scale=scale)


@pytest.mark.parametrize("which", ["scan_to_scan", "scan_to_map"])
@pytest.mark.parametrize("variant", ["deferred", "deferred_tail", "degen"])
def test_solves_variants(scene, variant, which):
    """Both outer loops under each variant: accept counts equal, the pose
    within the 1e-4 of :func:`test_solves`."""
    import dataclasses
    sc = dataclasses.replace(SC, **_VARIANTS[variant])
    T0 = XI_TRUE * 0.9
    prior = XI_TRUE * 0.8

    def run(mod, conv, se3mod, scale):
        et = _targets(scene, mod, conv, "edge")
        pt = _targets(scene, mod, conv, "planar")
        args = (conv(scene["eq"]), conv(scene["eqm"]), conv(scene["pq"]),
                conv(scene["pqm"]), et, pt, se3mod.exp(conv(T0)), sc)
        kw = dict(prior_T=se3mod.exp(conv(prior)), prior_scale=scale)
        if which == "scan_to_scan":
            return mod.solve_scan_to_scan(*args, **kw)
        return mod.solve_scan_to_map(*args, **kw)

    T_j, d_j = run(jicp, _j, jse3, jnp.float32(1.0))
    T_t, d_t = run(ticp, _t, tse3, torch.tensor(1.0))
    np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), atol=1e-4)
    assert int(d_t.lm_accept) == int(d_j.lm_accept)
    assert bool(d_t.degenerate) == bool(d_j.degenerate)
    for f in ("n_edge", "n_planar"):
        assert abs(int(getattr(d_t, f)) - int(getattr(d_j, f))) \
            <= 0.01 * int(getattr(d_j, f)), f


def test_reprojection_matches_reference():
    tr = _tracks()
    rng = np.random.default_rng(32)
    Xc = (tr["X"] @ tr["T_cv"][:3, :3].T + tr["T_cv"][:3, 3]).astype(
        np.float32)
    Xc[:6, 2] = [0.0, 0.05, 0.1, 0.11, -3.0, 1e-9]  # the z > 0.1 gate
    valid = rng.random(len(Xc)) < 0.9
    rj, dj, okj = jres.reprojection(_j(Xc), _j(tr["P"]), _j(tr["obs"]),
                                    _j(valid))
    rt, dt, okt = tres.reprojection(_t(Xc), _t(tr["P"]), _t(tr["obs"]),
                                    _t(valid))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    # Pixels of points up to 35 m through fx ~ 2e2: float32 leaves ~1e-4 px.
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=2e-4)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5,
                               atol=1e-5)


def _epi_inputs(xi):
    tr = _tracks()
    T = np.asarray(jse3.exp(_j(np.asarray(xi, np.float32))), np.float32)
    T_vc = np.linalg.inv(tr["T_cv"].astype(np.float64)).astype(np.float32)
    A = (tr["T_cv"].astype(np.float64)
         @ np.linalg.inv(T.astype(np.float64))).astype(np.float32)
    return tr, T, T_vc, A


@pytest.mark.parametrize("xi", ["true", "still"])
def test_epipolar_matches_reference(xi):
    """The residual, against JAX; "still" has no baseline, so every track
    is masked."""
    tr, T, T_vc, A = _epi_inputs(XI_TRUE if xi == "true" else np.zeros(6))
    M = (A.astype(np.float64) @ T_vc).astype(np.float32)
    K = tr["P"][:3, :3]
    rj, okj = jres.epipolar(_j(M), _j(K), _j(tr["uv_prev"]), _j(tr["obs"]),
                            _j(tr["nodepth"]))
    rt, okt = tres.epipolar(_t(M), _t(K), _t(tr["uv_prev"]), _t(tr["obs"]),
                            _t(tr["nodepth"]))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    assert okt.numpy().any() == (xi == "true")
    # Float32 E and lines in JAX against float64 in the port: 1e-3 px.
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-3)


def test_epipolar_jacobian_matches_jacfwd():
    """The port's analytic epipolar Jacobian against ``jax.jacfwd`` of the
    reference's residual over the six left-perturbation parameters, as
    ``_vis_prior_terms6`` takes it."""
    tr, T, T_vc, A = _epi_inputs(XI_TRUE * 0.9)
    K = tr["P"][:3, :3]
    T_cv = _j(tr["T_cv"])

    def epi(x):
        M = T_cv @ jse3.inv(jse3.exp(x) @ _j(T)) @ _j(T_vc)
        return jres.epipolar(M, _j(K), _j(tr["uv_prev"]), _j(tr["obs"]),
                             _j(tr["nodepth"]))[0]

    J_j = np.asarray(jax.jacfwd(epi)(jnp.zeros(6, jnp.float32)))
    _, ok = tres.epipolar(_t(A.astype(np.float64) @ T_vc), _t(K),
                          _t(tr["uv_prev"]), _t(tr["obs"]),
                          _t(tr["nodepth"]))
    J_t = tres.epipolar_jacobian(_t(A), _t(T_vc), _t(K), _t(tr["uv_prev"]),
                                 _t(tr["obs"]), ok).numpy()
    assert ok.numpy().sum() > 20
    assert not J_t[~ok.numpy()].any() and not J_j[~ok.numpy()].any()
    # jacfwd runs in float32 through exp, inv and three 4x4 products:
    # 1e-3 of each column's scale.
    scale = np.abs(J_j).max(0, keepdims=True)
    np.testing.assert_allclose(J_t, J_j, atol=1e-3 * scale.max(), rtol=1e-3)
