"""``batch.batched_run_scan`` on the CPU against the reference's
``velo_tpu.pipeline.batch.batched_run_scan`` over B = 2 sequences of the
tiny LiDAR drive (seeds 3 and 4, 3 frames each), within 5 cm / 0.1 deg
on every frame, and each sequence bitwise equal to its own single
``run_scan``."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_run_scan import (BASE, N_FRAMES, assert_poses_close,
                                 config)
from velo_tpu.io import fixtures
from velo_tpu.lidar import rangeimage as jri
from velo_tpu.pipeline import batch as jbatch
from velo_tpu.pipeline import odometry as jodo
from velo_tpu_torch.pipeline import batch as tbatch
from velo_tpu_torch.pipeline import odometry as todo

torch.set_num_threads(1)


def test_batched_run_scan_against_jax():
    cfg = config(False)
    seqs = []
    for seed in (3, 4):
        fx = fixtures.make_fixture(n_frames=N_FRAMES,
                                   n_rings=BASE.lidar.n_rings,
                                   n_azimuth=BASE.lidar.n_azimuth,
                                   with_images=False, seed=seed)
        seqs.append([jri.bin_scan_host(s, cfg.lidar) for s in fx.scans])
    scans = np.stack([[g[0] for g in s] for s in seqs])
    masks = np.stack([[g[1] for g in s] for s in seqs])

    bcarry = tbatch.broadcast_carry(todo.init_carry(cfg, "cpu"), 2)
    final, out = tbatch.batched_run_scan(cfg)(bcarry, torch.tensor(scans),
                                              torch.tensor(masks))
    assert out.T_w.shape == (2, N_FRAMES, 4, 4)
    assert final.frame_host == N_FRAMES
    assert torch.equal(final.frame_idx, torch.full((2,), N_FRAMES,
                                                   dtype=torch.int32))

    carry0 = jodo.init_carry(cfg)
    jcarry = jax.tree.map(lambda x: jnp.broadcast_to(x[None], (2,) + x.shape),
                          carry0)
    _, jout = jax.jit(jbatch.batched_run_scan(cfg))(
        jcarry, jnp.asarray(scans), jnp.asarray(masks))
    for b in range(2):
        assert_poses_close(out.T_w[b].numpy(), np.asarray(jout.T_w[b]))
        _, single = todo.run_scan(todo.init_carry(cfg, "cpu"),
                                  torch.tensor(scans[b]),
                                  torch.tensor(masks[b]), cfg)
        for k in single._fields:
            assert torch.equal(getattr(out, k)[b], getattr(single, k)), k
