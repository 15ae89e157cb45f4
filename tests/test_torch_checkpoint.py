"""Port parity of ``pipeline/checkpoint.py`` and of checkpoint / resume in
the frame loop.

The carry is the state that crosses between the two packages: the port
writes the reference's ``.npz`` layout with the reference's leaf names, so
a checkpoint written by either loads into the other, and each continues
within the single-step gate (1 cm / 0.05 deg) of the other.  Shapes are
those of the reference's own checkpoint test, 16 x 256 raw scans, except
for that gate: with ~55 correspondences a frame (just above the
degenerate-frame limit of 20) one plane fit on either side of a gate moves
a 16 x 256 pose by centimetres, so the crossing is tested at the tiny
configuration of the odometry tests (32 x 1024, pre-binned), on fixture
seed 1 (frame 4 from a shared carry: 1.3 mm / 0.013 deg; seeds 0 and 5:
3.2 mm and 1.3 mm; seed 3, which the odometry tests use for frames 0-3,
has at frame 4 its largest single-step divergence, 1.3 cm).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from velo_tpu import config as jconfig
from velo_tpu.io import fixtures, kitti
from velo_tpu.pipeline import checkpoint as jckpt
from velo_tpu.pipeline import odometry as jodo
from velo_tpu_torch.pipeline import checkpoint as tckpt
from velo_tpu_torch.pipeline import odometry as todo
from test_torch_odometry import _pose_diff

torch.set_num_threads(1)

N_MAX = 4096
CFG = jconfig.VeloConfig(
    lidar=jconfig.LidarConfig(n_rings=16, n_azimuth=256, n_sectors=8),
    solver=jconfig.SolverConfig(hash_capacity=1024, icp_iters_odom=2,
                                icp_iters_map=2, icp_iters_redeskew=1,
                                lm_iters=2),
    map=jconfig.MapConfig(edge_capacity=1024, planar_capacity=2048),
    n_max_points=N_MAX, use_vision=False, use_map=True)
TINY = dataclasses.replace(jconfig.tiny_test_config(), use_vision=False,
                           use_map=True, prebin_host=True)
FUSED = dataclasses.replace(
    CFG, use_vision=True,
    vision=jconfig.VisionConfig(height=64, width=192, k_tracks=64,
                                grid_cols=12))


@pytest.fixture(scope="module")
def seq():
    fx = fixtures.make_fixture(n_frames=6, n_rings=16, n_azimuth=256,
                               with_images=False)
    return [kitti.pad_scan(s, N_MAX) for s in fx.scans]


def _leaves(carry):
    return [x.numpy() for _, x in tckpt._flatten(carry)]


def test_carry_roundtrip(tmp_path, seq):
    carry = todo.init_carry(CFG, device="cpu")
    for scan, mask in seq[:2]:
        carry, _ = todo.step(carry, torch.tensor(scan), torch.tensor(mask),
                             CFG)
    path = str(tmp_path / "carry.npz")
    tckpt.save_carry(path, carry, frame_idx=2)
    loaded = tckpt.load_carry(path, todo.init_carry(CFG, device="cpu"))
    assert len(_leaves(carry)) == len(_leaves(loaded)) > 0
    for a, b in zip(_leaves(carry), _leaves(loaded)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert loaded.frame_host == 2 and int(loaded.frame_idx) == 2
    assert loaded.T_w.device.type == "cpu"
    assert tckpt.checkpoint_frame(path) == 2
    assert tckpt.load_history(path) == {}
    assert not (tmp_path / "carry.npz.tmp.npz").exists()


def test_structure_mismatch_rejected(tmp_path):
    path = str(tmp_path / "carry.npz")
    tckpt.save_carry(path, todo.init_carry(CFG, device="cpu"), frame_idx=0)
    other = dataclasses.replace(CFG, map=jconfig.MapConfig(
        edge_capacity=512, planar_capacity=1024))
    with pytest.raises(ValueError, match="shape"):
        tckpt.load_carry(path, todo.init_carry(other, device="cpu"))
    with pytest.raises(ValueError, match="structure mismatch"):
        tckpt.load_carry(path, todo.init_carry(FUSED, device="cpu"))


@pytest.mark.parametrize("fused", [False, True])
def test_leaf_names_equal_the_reference(fused):
    """The same names in the same order, with the same shapes and dtypes,
    as ``jax.tree_util.keystr`` gives the reference's carry."""
    cfg = FUSED if fused else CFG
    names_j, arrays_j = jckpt._leaf_names(jodo.init_carry(cfg))
    flat_t = tckpt._flatten(todo.init_carry(cfg, device="cpu"))
    assert [n for n, _ in flat_t] == names_j
    assert any(n.startswith(".vision.") for n in names_j) == fused
    for (name, t), a in zip(flat_t, arrays_j):
        assert tuple(t.shape) == a.shape, name
        assert t.numpy().dtype == a.dtype, name


def test_resume_equals_uninterrupted_bitwise(tmp_path, seq):
    path = str(tmp_path / "ck.npz")
    full, fdiag = todo.run_sequence_host(seq, CFG, device="cpu")
    # First run: checkpoint every 3 frames, stop after 3.
    todo.run_sequence_host(iter(seq[:3]), CFG, checkpoint_path=path,
                           checkpoint_every=3, device="cpu")
    assert tckpt.checkpoint_frame(path) == 3
    hist = tckpt.load_history(path)
    assert hist["poses"].shape == (3, 4, 4)
    assert set(hist) == set(todo.FrameResult._fields[1:]) | {"poses"}
    # The resumed run reads its frames from a generator and returns the
    # whole trajectory.
    resumed, rdiag = todo.run_sequence_host(
        (f for f in seq), CFG, checkpoint_path=path, resume=True,
        device="cpu")
    np.testing.assert_array_equal(resumed, full)
    assert set(rdiag) == set(fdiag)
    for k in fdiag:
        assert rdiag[k].dtype == fdiag[k].dtype, k
        np.testing.assert_array_equal(rdiag[k], fdiag[k], k)


def test_resume_refusals(tmp_path, seq):
    path = str(tmp_path / "ck.npz")
    with pytest.raises(FileNotFoundError, match="--resume"):
        todo.run_sequence_host(seq, CFG, checkpoint_path=path, resume=True,
                               device="cpu")
    # A checkpoint without pose history would give a truncated trajectory.
    tckpt.save_carry(path, todo.init_carry(CFG, device="cpu"), frame_idx=0)
    with pytest.raises(ValueError, match="history"):
        todo.run_sequence_host(seq, CFG, checkpoint_path=path, resume=True,
                               device="cpu")


@pytest.fixture(scope="module")
def tiny_seq():
    from velo_tpu.lidar import rangeimage as jri
    fx = fixtures.make_fixture(n_frames=5, n_rings=32, n_azimuth=1024,
                               with_images=False, seed=1)
    return [jri.bin_scan_host(s, TINY.lidar) for s in fx.scans]


def test_checkpoints_cross_between_the_packages(tmp_path, tiny_seq):
    """A checkpoint written by ``velo_tpu`` after 4 frames loads into the
    port and one written by the port loads into ``velo_tpu``; each then
    continues within the single-step gate of the other."""
    pj, pt = str(tmp_path / "jax.npz"), str(tmp_path / "torch.npz")
    jodo.run_sequence_host(tiny_seq[:4], TINY, checkpoint_path=pj,
                           checkpoint_every=4)
    todo.run_sequence_host(tiny_seq[:4], TINY, checkpoint_path=pt,
                           checkpoint_every=4, device="cpu")

    # velo_tpu's checkpoint into the port: the leaves arrive unchanged, and
    # frame 4 from there lands where the reference's own frame 4 does.
    carry_j = jckpt.load_carry(pj, jodo.init_carry(TINY))
    carry_t = tckpt.load_carry(pj, todo.init_carry(TINY, device="cpu"))
    assert carry_t.frame_host == 4
    for a, b in zip(_leaves(carry_t), jax.tree.leaves(carry_j)):
        np.testing.assert_array_equal(a, np.asarray(b))
    _, out_j = jodo.jit_step(carry_j, jnp.asarray(tiny_seq[4][0]),
                             jnp.asarray(tiny_seq[4][1]), TINY)
    _, out_t = todo.step(carry_t, torch.tensor(tiny_seq[4][0]),
                         torch.tensor(tiny_seq[4][1]), TINY)
    dt, dr = _pose_diff(out_t.T_w.numpy(), np.asarray(out_j.T_w))
    print(f"reference's checkpoint, frame 4: {dt:.5f} m, {dr:.5f} deg")
    assert dt < 0.01 and dr < 0.05

    # The port's checkpoint into velo_tpu, through its own resume.
    carry_j2 = jckpt.load_carry(pt, jodo.init_carry(TINY))
    carry_t2 = tckpt.load_carry(pt, todo.init_carry(TINY, device="cpu"))
    for a, b in zip(_leaves(carry_t2), jax.tree.leaves(carry_j2)):
        np.testing.assert_array_equal(a, np.asarray(b))
    resumed_j, _ = jodo.run_sequence_host(tiny_seq[:5], TINY,
                                          checkpoint_path=pt, resume=True)
    resumed_t, _ = todo.run_sequence_host(tiny_seq[:5], TINY,
                                          checkpoint_path=pt, resume=True,
                                          device="cpu")
    assert resumed_j.shape == resumed_t.shape == (5, 4, 4)
    np.testing.assert_array_equal(resumed_j[:4], resumed_t[:4])
    dt, dr = _pose_diff(resumed_t[4], resumed_j[4])
    print(f"port's checkpoint, frame 4: {dt:.5f} m, {dr:.5f} deg")
    assert dt < 0.01 and dr < 0.05
