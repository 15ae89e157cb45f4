"""Config 5 in the port, on the CPU: ``pipeline.batch.run_sequences`` runs
B sequences as one ``torch.func.vmap``-ped step per frame, and each
sequence comes out bitwise equal to its own ``odometry.run_sequence``.

Every test runs with functorch's per-sample fallback disabled, so an
operation of the step without a batching rule raises instead of looping
over the sequences.  The kernels' plain versions run under ``vmap`` as
plain torch; their batched launches are checked on the card
(``tests/test_torch_dist_topk.py``, ``tests/test_torch_klt_l0.py``).
"""
import dataclasses

import numpy as np
import pytest
import torch

from velo_tpu_torch import config as tconfig
from velo_tpu_torch.evaluation import profiling
from velo_tpu_torch.geom import camera as tcam
from velo_tpu_torch.io import fixtures, kitti
from velo_tpu_torch.kernels import dist_topk as dtk
from velo_tpu_torch.kernels import klt_l0 as kl
from velo_tpu_torch.lidar import rangeimage as ri
from velo_tpu_torch.pipeline import batch, odometry
from test_torch_dist_topk import _problem
from test_torch_klt_l0 import _setup


def _launches(kernel: str) -> int:
    """The kernel's launches so far in this process."""
    return profiling.counters().get(f"kernel.{kernel}", (0, 0.0))[0]


torch.set_num_threads(1)

SEEDS = (100, 101)  # the batch mode's seeds, 100 + b
N_FRAMES = 3
BASE = tconfig.tiny_test_config()


@pytest.fixture(autouse=True)
def no_vmap_fallback():
    torch._C._functorch._set_vmap_fallback_enabled(False)
    yield
    torch._C._functorch._set_vmap_fallback_enabled(True)


@pytest.fixture(scope="module")
def drives():
    """The two drives with images (the scans do not depend on them)."""
    vc = BASE.vision
    return [fixtures.make_fixture(
        n_frames=N_FRAMES, n_rings=BASE.lidar.n_rings,
        n_azimuth=BASE.lidar.n_azimuth, height=vc.height, width=vc.width,
        seed=s) for s in SEEDS]


def _cfg(mode):
    return dataclasses.replace(
        BASE, use_vision=mode == "fused", prebin_host=mode != "no-prebin",
        vision=dataclasses.replace(BASE.vision, klt_impl="pallas"))


def _inputs(drives, cfg):
    """(scans, masks, images, cam, per-sequence frame lists)."""
    def frame(s):
        if cfg.prebin_host:
            return ri.bin_scan_host(s, cfg.lidar)
        return kitti.pad_scan(s, cfg.n_max_points)

    per_seq = [[frame(s) + ((fx.images[i],) if cfg.use_vision else ())
                for i, s in enumerate(fx.scans)] for fx in drives]
    scans = np.stack([np.stack([f[0] for f in fr]) for fr in per_seq])
    masks = np.stack([np.stack([f[1] for f in fr]) for fr in per_seq])
    images = cam = None
    if cfg.use_vision:
        images = np.stack([fx.images for fx in drives])
        cam = tcam.from_numpy(drives[0].P, drives[0].T_cam_velo,
                              cfg.vision.width, cfg.vision.height, "cpu")
    return scans, masks, images, cam, per_seq


def _batched(drives, mode):
    cfg = _cfg(mode)
    scans, masks, images, cam, per_seq = _inputs(drives, cfg)
    poses, diag = batch.run_sequences(scans, masks, cfg, images=images,
                                      cam=cam, device="cpu")
    return cfg, cam, per_seq, poses, diag


@pytest.fixture(scope="module")
def lidar_batched(drives):
    """The LiDAR-only batched run, shared by two tests."""
    return _batched(drives, "lidar")


@pytest.mark.parametrize("mode", ["lidar", "fused", "no-prebin"])
def test_each_sequence_is_its_single_sequence_run(drives, mode, request):
    cfg, cam, per_seq, poses, diag = (
        request.getfixturevalue("lidar_batched") if mode == "lidar"
        else _batched(drives, mode))
    assert poses.shape == (len(SEEDS), N_FRAMES, 4, 4)
    assert set(diag) == set(odometry.FrameResult._fields) - {"T_w"}
    for b, frames in enumerate(per_seq):
        p1, d1, _ = odometry.run_sequence(frames, cfg, device="cpu", cam=cam)
        assert np.array_equal(poses[b], p1), (mode, b)
        for k, v in d1.items():
            assert diag[k].shape == (len(SEEDS), N_FRAMES)
            assert np.array_equal(diag[k][b], v), (mode, b, k)
    if mode == "fused":
        assert (diag["n_depth"][:, -1] > 0).all()  # the visual blocks ran


def test_shard_over_two_devices(drives, lidar_batched):
    """Two CPU devices, one sequence each: the unsharded result, bitwise;
    a batch that does not split evenly is refused."""
    cfg, _, _, poses, diag = lidar_batched
    scans, masks, _, _, _ = _inputs(drives, cfg)
    cpus = [torch.device("cpu"), torch.device("cpu")]
    sp, sd = batch.run_sequences(scans, masks, cfg, shard=True,
                                 device="cpu", devices=cpus)
    assert np.array_equal(sp, poses)
    assert all(np.array_equal(sd[k], diag[k]) for k in diag)
    three = np.concatenate([scans, scans[:1]])
    with pytest.raises(ValueError, match="not divisible"):
        batch.run_sequences(three, np.concatenate([masks, masks[:1]]), cfg,
                            shard=True, device="cpu", devices=cpus)


def test_vision_needs_images_and_cam(drives):
    cfg = _cfg("fused")
    scans, masks, images, cam, _ = _inputs(drives, cfg)
    with pytest.raises(ValueError, match="images and cam"):
        batch.run_sequences(scans, masks, cfg, images=images, device="cpu")


@pytest.mark.parametrize("shared", [False, True])
def test_dist_topk_plain_under_vmap(shared):
    """Batched inputs, and targets shared by all sequences (in_dims None):
    the per-sample calls' results, and no launch on the CPU."""
    probs = [_problem(s, 300, 3072) for s in (1, 2, 3)]
    t, tm, qs = (torch.tensor(np.stack(x)) for x in zip(*probs))
    before = _launches("dist_topk")
    if shared:
        d2, idx = torch.func.vmap(
            lambda q: dtk.dist_topk(t[0], tm[0], q, 16, 4))(qs)
    else:
        d2, idx = torch.func.vmap(
            lambda a, m, q: dtk.dist_topk(a, m, q, 16, 4))(t, tm, qs)
    assert _launches("dist_topk") == before
    for b in range(3):
        j = 0 if shared else b
        rd2, ridx = dtk.dist_topk_reference(t[j], tm[j], qs[b], 16, 4)
        assert torch.equal(d2[b], rd2) and torch.equal(idx[b], ridx)


@pytest.mark.parametrize("shared", [False, True])
def test_klt_l0_plain_under_vmap(shared):
    sets = [_setup(s) for s in (4, 5, 6)]
    prev, cur, up, uc = (torch.tensor(np.stack(x)) for x in zip(*sets))
    cfg = tconfig.VisionConfig(height=64, width=512)
    before = _launches("klt_l0")
    if shared:
        uv, ok = torch.func.vmap(lambda a, b: kl.track_level0(
            prev[0], cur[0], a, b, cfg, 6))(up, uc)
    else:
        uv, ok = torch.func.vmap(lambda *x: kl.track_level0(
            *x, cfg, 6))(prev, cur, up, uc)
    assert _launches("klt_l0") == before
    for b in range(3):
        j = 0 if shared else b
        ruv, rok = kl.track_level0_reference(prev[j], cur[j], up[b], uc[b],
                                             cfg, 6)
        assert torch.equal(uv[b], ruv) and torch.equal(ok[b], rok)


def test_batched_ops_on_the_cpu_are_the_plain_versions():
    """The custom operators take a leading batch axis; on CPU tensors they
    run the plain version per sequence, and their batching rules fold a
    vmapped axis into that one."""
    probs = [_problem(s, 100, 1024) for s in (7, 8)]
    t, tm, qs = (torch.tensor(np.stack(x)) for x in zip(*probs))
    d2, idx = torch.ops.velo_tpu_torch.dist_topk(t, tm, qs, 8, 4)
    assert d2.shape == idx.shape == (2, 100, 8)
    vd2, vidx = torch.func.vmap(lambda a, m, q: dtk._batched(
        a[None], m[None], q[None], 8, 4))(t, tm, qs)
    assert vd2.shape == (2, 1, 100, 8)
    for b in range(2):
        rd2, ridx = dtk.dist_topk_reference(t[b], tm[b], qs[b], 8, 4)
        assert torch.equal(d2[b], rd2) and torch.equal(idx[b], ridx)
        assert torch.equal(vd2[b, 0], rd2) and torch.equal(vidx[b, 0], ridx)
    prev, cur, up, uc = (torch.tensor(x)[None] for x in _setup(9))
    uv, ok = torch.ops.velo_tpu_torch.klt_l0(prev, cur, up, uc, 4)
    ruv, rok = kl.track_level0_reference(
        prev[0], cur[0], up[0], uc[0], tconfig.VisionConfig(height=64,
                                                            width=512), 4)
    assert torch.equal(uv[0], ruv) and torch.equal(ok[0], rok)


# Per-sequence path shapes at 64 x 2048 (Q, N, bin_factor).
FULL_PATH = [(1024, 3072, 4), (2048, 6144, 4), (1024, 16384, 32),
             (2048, 32768, 32)]


@pytest.mark.parametrize("q,n,bf", FULL_PATH)
@pytest.mark.parametrize("batch_size", [1, 2, 4, 8])
def test_launch_geometry_with_batch(q, n, bf, batch_size):
    """The largest register tile of queries whose grid, over all
    sequences, still gives each of the 132 SMs a block."""
    g = dtk.launch_geometry(q, n, bf, 16, batch_size)
    one = dtk.launch_geometry(q, n, bf, 16)
    assert (g.tn, g.nbt, g.nb, g.threads) == (one.tn, one.nbt, one.nb,
                                              one.threads)
    assert g.blocks == -(-q // g.tq) and g.tq >= one.tq
    assert batch_size * g.blocks >= 132 or g.tq == 1
    bigger = [t for t in (2, 4, 8) if t > g.tq]
    assert all(batch_size * -(-q // t) < 132 for t in bigger)
    assert g.smem_bytes == 4 * g.tq * 32 * (-(-g.nb // 32) | 1)


@pytest.mark.parametrize("batch_size", [0, 65536])
def test_launch_geometry_refuses_a_batch_the_grid_cannot_take(batch_size):
    with pytest.raises(ValueError):
        dtk.launch_geometry(1024, 3072, 4, 16, batch_size)
