"""Port parity of the continuous-time sweep solve (``ct_sweep``): the
12-DoF system ``icp.make_lidar_system_ct`` and its staged prior, the LM
``lm.lm_solve_ct``, and the odometry step's ct_sweep branch, against
``velo_tpu``.

The system is compared at one linearization on the box scene of
``test_torch_solve.py`` (rtol 1e-4, atol 1e-5 of the largest entry, as
the 6-DoF system there), LiDAR-only and with the visual blocks; the step
on the tiny drive of ``test_torch_odometry.py``: one step from a shared
carry 1 cm / 0.05 deg, four frames end to end 5 cm / 0.1 deg.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from velo_tpu import config as jconfig
from velo_tpu.geom import se3 as jse3
from velo_tpu.io import fixtures
from velo_tpu.lidar import rangeimage as jri
from velo_tpu.pipeline import odometry as jodo
from velo_tpu.solve import icp as jicp
from velo_tpu.solve import lm as jlm
from velo_tpu_torch.geom import se3 as tse3
from velo_tpu_torch.pipeline import odometry as todo
from velo_tpu_torch.solve import icp as ticp
from velo_tpu_torch.solve import lm as tlm
from test_torch_odometry import _pose_diff
from test_torch_solve import SC, XI_TRUE, _j, _make_scene, _t, _targets, _vis

torch.set_num_threads(1)

N_FRAMES = 4
CFG = jconfig.apply_overrides(dataclasses.replace(
    jconfig.tiny_test_config(), use_vision=False, use_map=True,
    prebin_host=True), "s:ct_sweep=1")


@pytest.fixture(scope="module")
def scene():
    return _make_scene()


@pytest.fixture(scope="module")
def corr(scene):
    """One outer iteration's correspondences at T0 (the port's search; the
    two systems below take the same numbers), with features measured at
    random sweep phases."""
    rng = np.random.default_rng(5)
    T0 = tse3.exp(_t(XI_TRUE * 0.9))
    ec = ticp.build_candidates(_targets(scene, ticp, _t, "edge"),
                               _t(scene["eq"]), _t(scene["eqm"]), T0, SC)
    pc = ticp.build_candidates(_targets(scene, ticp, _t, "planar"),
                               _t(scene["pq"]), _t(scene["pqm"]), T0, SC)
    a, b, e_ok = ticp._edge_lines_2pt(ticp._cand_query(ec, SC),
                                      tse3.apply(T0, _t(scene["eq"])),
                                      _t(scene["eqm"]))
    n, d, p_ok, p_q = ticp._planar_planes_fit(
        ticp._cand_query(pc, SC), tse3.apply(T0, _t(scene["pq"])),
        _t(scene["pqm"]), SC.map_knn)
    assert int(e_ok.sum()) > 100 and int(p_ok.sum()) > 300
    return [np.asarray(x) for x in (
        scene["eq"], rng.random(len(scene["eq"])).astype(np.float32),
        scene["eqm"], a, b, e_ok, scene["pq"],
        rng.random(len(scene["pq"])).astype(np.float32), scene["pqm"], n, d,
        p_ok)] + [p_q.numpy()]


def _ct_system(corr, mod, conv, se3mod, vis, prior):
    """(T0, xi_ref, the system with the prior inside, its stage) for
    either package."""
    T0 = se3mod.exp(conv(XI_TRUE * 0.9))
    xi_ref = conv(XI_TRUE * 0.85)
    args = [conv(x) for x in corr[:12]] + [xi_ref, SC]
    p_q = conv(corr[12])
    prior_T = se3mod.exp(conv(XI_TRUE * 0.8))
    scale = conv(np.float32(1.0))
    full = mod.make_lidar_system_ct(*args, vis=vis, planar_q=p_q,
                                    prior_T=prior_T if prior else None,
                                    prior_scale=scale if prior else None)
    stage = mod._make_stage_ct(SC, prior_T, scale, mod.make_lidar_system_ct(
        *args, vis=vis, planar_q=p_q)) if prior else None
    return T0, xi_ref, full, stage


def _close(a, b):
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, rtol=1e-4,
                               atol=1e-5 * np.abs(b).max())


@pytest.mark.parametrize("prior", [False, True], ids=["no-prior", "prior"])
@pytest.mark.parametrize("fused", [False, True], ids=["lidar", "fused"])
def test_ct_system_at_one_linearization(corr, fused, prior):
    """H (12 x 12), g and cost of ``make_lidar_system_ct`` (the dynamic
    prior inside) and of its stage, at one linearization."""
    vj = _vis(jicp, _j, jnp.float32(0.75)) if fused else None
    vt = _vis(ticp, _t, torch.tensor(0.75)) if fused else None
    Tj, xj, sys_j, st_j = _ct_system(corr, jicp, _j, jse3, vj, prior)
    Tt, xt, sys_t, st_t = _ct_system(corr, ticp, _t, tse3, vt, prior)
    sys_j = jax.jit(sys_j)
    stage_j = jax.jit(lambda T, xi2: st_j(T, xi2)[:3]) if prior else None
    for xi2 in (XI_TRUE * 0.85, XI_TRUE * 1.1):
        outs = [(sys_t(Tt, _t(xi2)), sys_j(Tj, _j(xi2)))]
        if prior:
            outs.append((st_t(Tt, _t(xi2))[:3], stage_j(Tj, _j(xi2))))
        for ot, oj in outs:
            assert ot[0].shape == (12, 12) and ot[1].shape == (12,)
            for a, b in zip(ot, oj):
                _close(a, b)


@pytest.mark.parametrize("prior", [False, True], ids=["no-prior", "prior"])
def test_lm_solve_ct(corr, prior):
    """Accepted steps, convergence and the solved (T, xi2) after 4
    LM iterations; the initial cost where no iteration runs."""
    Tj, xj, sys_j, st_j = _ct_system(corr, jicp, _j, jse3, None, prior)
    Tt, xt, sys_t, st_t = _ct_system(corr, ticp, _t, tse3, None, prior)
    for iters in (0, 4):
        T_j, x_j, s_j = jax.jit(lambda T, x: jlm.lm_solve_ct(
            sys_j, T, x, SC, iters=iters, stage=st_j))(Tj, xj)
        T_t, x_t, s_t = tlm.lm_solve_ct(sys_t, Tt, xt, SC, iters=iters,
                                        stage=st_t)
        assert int(s_t.n_accept) == int(s_j.n_accept), iters
        assert bool(s_t.converged) == bool(s_j.converged), iters
        np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), atol=1e-5)
        np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), atol=1e-5)
        if iters == 0:  # inf with a stage, else the cost at (T0, xi2_0)
            _close(s_t.cost, s_j.cost)
        else:
            np.testing.assert_allclose(float(s_t.cost), float(s_j.cost),
                                       rtol=1e-4)


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


@pytest.mark.parametrize("frame", [1, 3])
def test_ct_single_step_from_shared_carry(frames, reference, frame):
    carries, poses = reference
    carry = todo.carry_from_jax_numpy(carries[frame], "cpu")
    g, v = frames[frame]
    _, out = todo.step(carry, torch.tensor(g), torch.tensor(v), CFG)
    dt, dr = _pose_diff(out.T_w.numpy(), poses[frame])
    print(f"ct_sweep frame {frame}: {dt:.5f} m, {dr:.5f} deg")
    assert dt < 0.01 and dr < 0.05


def test_ct_frames_end_to_end(frames, reference):
    _, ref_poses = reference
    poses, diags, _ = todo.run_sequence(frames, CFG, device="cpu")
    assert poses.shape == (N_FRAMES, 4, 4) and np.isfinite(poses).all()
    assert not diags["degenerate"][1:].any()
    worst = (0.0, 0.0)
    for f in range(N_FRAMES):
        dt, dr = _pose_diff(poses[f], ref_poses[f])
        print(f"ct_sweep frame {f}: {dt:.5f} m, {dr:.5f} deg")
        worst = (max(worst[0], dt), max(worst[1], dr))
    assert worst[0] < 0.05 and worst[1] < 0.1, worst


def test_ct_sweep_no_double_redeskew(frames, monkeypatch):
    """With ct_sweep the stored target features are already corrected with
    the solved sweep motion; the step must not redeskew them a second
    time: the step itself calls redeskew exactly 4 times (edges / planars
    x query / target), never 6 (the solver's own calls not counted)."""
    calls = []
    real = todo.deskew_mod
    proxy = types.SimpleNamespace(
        deskew=real.deskew, azimuth_phase=real.azimuth_phase,
        redeskew=lambda *a, **k: calls.append(1) or real.redeskew(*a, **k))
    monkeypatch.setattr(todo, "deskew_mod", proxy)
    carry = todo.init_carry(CFG, device="cpu")
    g, v = frames[0]
    todo.step(carry, torch.tensor(g), torch.tensor(v), CFG)
    assert len(calls) == 4
    calls.clear()
    plain = dataclasses.replace(CFG, solver=dataclasses.replace(
        CFG.solver, ct_sweep=False))
    todo.step(carry, torch.tensor(g), torch.tensor(v), plain)
    assert len(calls) == 6  # redeskew before the re-solve, then step 6
