"""Port parity of the voxel-hash engine (``nn_engine="hash"``):
``mapping/voxel_hash.build_grid`` / ``knn`` against
``velo_tpu.mapping.voxel_hash`` and scipy's cKDTree, and the odometry
step with the hash engine against JAX.

``knn`` must give the reference's idx and valid exactly, dist within 1e-6
(measured 2.4e-7): its top-k is a stable sort on d², the reference's
``lax.top_k`` order (lower candidate slot first at equal d², the invalid
slots in slot order).  Poses: one step from a shared carry 1 cm /
0.05 deg, four frames end to end 5 cm / 0.1 deg, the gates of
``test_torch_odometry.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from velo_tpu import config as jconfig
from velo_tpu.io import fixtures
from velo_tpu.lidar import rangeimage as jri
from velo_tpu.mapping import voxel_hash as jvh
from velo_tpu.pipeline import odometry as jodo
from velo_tpu_torch.mapping import voxel_hash as tvh
from velo_tpu_torch.pipeline import odometry as todo
from velo_tpu_torch.solve import icp as ticp
from test_torch_batch_variants import SEEDS, batched_equals_single_runs
from test_torch_batch_variants import no_vmap_fallback  # noqa: F401
from test_torch_odometry import _pose_diff

torch.set_num_threads(1)

N_FRAMES = 4
CFG = jconfig.apply_overrides(dataclasses.replace(
    jconfig.tiny_test_config(), use_vision=False, use_map=True,
    prebin_host=True), "s:nn_engine=hash")


def _cloud(rng, n, extent):
    return ((rng.random((n, 3)) * 2 - 1) * extent).astype(np.float32)


def _problem(seed):
    """Targets with duplicates (exact d² ties) and a mask, a payload,
    masked queries, a centre off the origin."""
    rng = np.random.default_rng(seed)
    pts = _cloud(rng, 3000, 8.0)
    pts[100:400] = pts[0:300]
    mask = rng.random(3000) > 0.2
    queries = np.concatenate([pts[rng.integers(0, 3000, 300)]
                              + rng.normal(0, 0.3, (300, 3)),
                              _cloud(rng, 100, 8.0)]).astype(np.float32)
    qmask = rng.random(400) > 0.1
    payload = rng.integers(0, 64, (3000, 1)).astype(np.int32)
    center = np.array([0.4, -0.2, 0.1], np.float32)
    return pts, mask, queries, qmask, payload, center


@pytest.mark.parametrize("k, max_dist", [(5, 1.0), (3, 0.5), (16, 1.0)])
def test_knn_matches_the_reference(k, max_dist):
    pts, mask, q, qm, pay, c = _problem(k)
    gj = jvh.build_grid(jnp.asarray(pts), jnp.asarray(mask), 1.0,
                        center=jnp.asarray(c), payload=jnp.asarray(pay))
    gt = tvh.build_grid(torch.tensor(pts), torch.tensor(mask), 1.0,
                        center=torch.tensor(c), payload=torch.tensor(pay))
    for name in ("keys", "pts", "payload"):
        np.testing.assert_array_equal(getattr(gt, name).numpy(),
                                      np.asarray(getattr(gj, name)), name)
    ij, dj, vj = map(np.asarray, jvh.knn(gj, jnp.asarray(q), jnp.asarray(qm),
                                         k=k, max_dist=max_dist))
    it, dt, vt = tvh.knn(gt, torch.tensor(q), torch.tensor(qm), k=k,
                         max_dist=max_dist)
    np.testing.assert_array_equal(it.numpy(), ij)
    np.testing.assert_array_equal(vt.numpy(), vj)
    np.testing.assert_allclose(dt.numpy(), dj, rtol=0, atol=1e-6)
    assert not vt.numpy()[~qm].any() and vt.numpy().any()
    # The gathered payload rows follow.
    np.testing.assert_array_equal(gt.payload[it].numpy(),
                                  np.asarray(gj.payload)[ij])


def test_knn_exact_within_voxel_radius():
    """The reference's own oracle: every neighbour within one voxel, as
    cKDTree finds it, with masked targets left out."""
    rng = np.random.default_rng(11)
    pts = _cloud(rng, 4000, 20.0)
    mask = rng.random(4000) > 0.3
    queries = _cloud(rng, 512, 20.0)
    grid = tvh.build_grid(torch.tensor(pts), torch.tensor(mask), 1.0)
    idx, dist, valid = (x.numpy() for x in tvh.knn(
        grid, torch.tensor(queries), torch.ones(512, dtype=torch.bool), k=3,
        max_dist=1.0, occupancy=8))
    live = pts[mask]
    d_ref, i_ref = cKDTree(live).query(queries, k=3,
                                       distance_upper_bound=1.0)
    grid_pts = grid.pts.numpy()
    for qi in range(len(queries)):
        ref_valid = np.isfinite(d_ref[qi])
        assert valid[qi].sum() == ref_valid.sum(), qi
        np.testing.assert_allclose(np.sort(dist[qi][valid[qi]]),
                                   np.sort(d_ref[qi][ref_valid]), atol=1e-4)
        if ref_valid.any():
            np.testing.assert_allclose(
                np.sort(grid_pts[idx[qi][valid[qi]]], axis=0),
                np.sort(live[i_ref[qi][ref_valid]], axis=0), atol=1e-5)


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
def test_hash_single_step_from_shared_carry(frames, reference, frame,
                                            monkeypatch):
    carries, poses = reference

    def no_candidates(*a, **k):
        raise AssertionError("the hash engine ran the dense candidate search")

    # The hash engine bypasses dist_topk in both solves.
    monkeypatch.setattr(ticp, "build_candidates", no_candidates)
    carry = todo.carry_from_jax_numpy(carries[frame], "cpu")
    g, v = frames[frame]
    _, out = todo.step(carry, torch.tensor(g), torch.tensor(v), CFG)
    dt, dr = _pose_diff(out.T_w.numpy(), poses[frame])
    print(f"hash frame {frame}: {dt:.5f} m, {dr:.5f} deg")
    assert dt < 0.01 and dr < 0.05


def test_hash_frames_end_to_end(frames, reference):
    _, ref_poses = reference
    poses, diags, _ = todo.run_sequence(frames, CFG, device="cpu")
    assert poses.shape == (N_FRAMES, 4, 4) and np.isfinite(poses).all()
    assert not diags["degenerate"][1:].any()
    worst = (0.0, 0.0)
    for f in range(N_FRAMES):
        dt, dr = _pose_diff(poses[f], ref_poses[f])
        print(f"hash frame {f}: {dt:.5f} m, {dr:.5f} deg")
        worst = (max(worst[0], dt), max(worst[1], dr))
    assert worst[0] < 0.05 and worst[1] < 0.1, worst


def test_hash_batched_equals_single_runs(no_vmap_fallback):  # noqa: F811
    """The hash engine under ``torch.func.vmap`` with the per-sample
    fallback off (``searchsorted``, the stable sorts and the gathers have
    batching rules): each sequence bitwise equal to its single run."""
    drives = [fixtures.make_fixture(n_frames=3, n_rings=32, n_azimuth=1024,
                                    with_images=False, seed=s)
              for s in SEEDS]
    batched_equals_single_runs(drives, "s:nn_engine=hash", False)
