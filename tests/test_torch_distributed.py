"""``pipeline.distributed.run_sequences_multihost`` across two CPU
processes joined by ``torch.distributed`` (gloo over loopback), as
``tests/integration/test_multihost.py`` runs the reference with
``jax.distributed``.

Each process runs its 2 local sequences (3 frames of the tiny LiDAR
drive, seeds 100-103 over both processes) and asks for the global mean
cost.  Its poses and diagnostics must be bitwise equal to a
single-process ``batch.run_sequences`` of the same sequences (the
sequences are independent, and a batched sequence equals its single
run), and the global cost the mean over all 4 x 3 frames within 1e-6
relative (a float64 sum of float32 costs against numpy's mean).  Then
the 4 sequences against JAX's ``velo_tpu.pipeline.batch.run_sequences``
within 5 cm / 0.1 deg on every frame.
"""
import dataclasses
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_odometry import _pose_diff
from velo_tpu import config as jconfig
from velo_tpu.io import fixtures
from velo_tpu.lidar import rangeimage as jri
from velo_tpu.pipeline import batch as jbatch
from velo_tpu_torch.pipeline import batch as tbatch
from velo_tpu_torch.pipeline import distributed as tdist

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B_LOCAL, F, SEED0 = 2, 3, 100
CFG = dataclasses.replace(jconfig.tiny_test_config(), use_vision=False,
                          use_map=True, prebin_host=True)

WORKER = r"""
import dataclasses, datetime, sys
sys.path.insert(0, {repo!r})
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
dist.init_process_group("gloo", init_method={init!r}, world_size=2,
                        rank={rank}, timeout=datetime.timedelta(seconds=300))
from velo_tpu_torch import config
from velo_tpu_torch.io import fixtures
from velo_tpu_torch.lidar import rangeimage
from velo_tpu_torch.pipeline import distributed

cfg = dataclasses.replace(config.tiny_test_config(), use_vision=False,
                          use_map=True, prebin_host=True)
scans, masks = [], []
for b in range({b_local}):
    fx = fixtures.make_fixture(
        n_frames={f}, n_rings=cfg.lidar.n_rings,
        n_azimuth=cfg.lidar.n_azimuth, with_images=False,
        seed={seed0} + {rank} * {b_local} + b)
    grids = [rangeimage.bin_scan_host(s, cfg.lidar) for s in fx.scans]
    scans.append(np.stack([g[0] for g in grids]))
    masks.append(np.stack([g[1] for g in grids]))
poses, diag, gcost = distributed.run_sequences_multihost(
    np.stack(scans), np.stack(masks), cfg, with_global_cost=True,
    device="cpu")
np.savez({out!r}, poses=poses, gcost=gcost,
         **{{"diag_" + k: v for k, v in diag.items()}})
dist.destroy_process_group()
print("WORKER_OK", {rank}, flush=True)
"""


def _sequences():
    scans, masks = [], []
    for seed in range(SEED0, SEED0 + 2 * B_LOCAL):
        fx = fixtures.make_fixture(n_frames=F, n_rings=CFG.lidar.n_rings,
                                   n_azimuth=CFG.lidar.n_azimuth,
                                   with_images=False, seed=seed)
        grids = [jri.bin_scan_host(s, CFG.lidar) for s in fx.scans]
        scans.append(np.stack([g[0] for g in grids]))
        masks.append(np.stack([g[1] for g in grids]))
    return np.stack(scans), np.stack(masks)


def test_two_processes_match_single_process_runs(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo")
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER.format(
            repo=REPO, init=f"tcp://127.0.0.1:{port}", rank=rank,
            b_local=B_LOCAL, f=F, seed0=SEED0,
            out=str(tmp_path / f"rank{rank}.npz"))],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(2)]
    try:
        # Meanwhile, the same 4 sequences in this process: the port's
        # batch on the CPU, and the reference's.
        scans, masks = _sequences()
        single, sdiag = tbatch.run_sequences(scans, masks, CFG, device="cpu")
        ref, _ = jbatch.run_sequences(scans, masks, CFG)
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, (so, se)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{so}\n{se}"
        assert f"WORKER_OK {rank}" in so

    mean = float(np.mean(sdiag["cost"].astype(np.float64)))
    for rank in range(2):
        got = np.load(tmp_path / f"rank{rank}.npz")
        mine = slice(rank * B_LOCAL, (rank + 1) * B_LOCAL)
        assert np.array_equal(got["poses"], single[mine])
        for k, v in sdiag.items():
            assert np.array_equal(got["diag_" + k], v[mine]), k
        assert abs(float(got["gcost"]) - mean) <= 1e-6 * abs(mean)

    for b in range(2 * B_LOCAL):
        for f in range(F):
            dt, dr = _pose_diff(single[b, f], ref[b, f])
            assert dt < 0.05 and dr < 0.1, (b, f, dt, dr)


def test_needs_a_process_group():
    with pytest.raises(RuntimeError, match="init_process_group"):
        tdist.run_sequences_multihost(np.zeros((1, 1, 4, 4, 5), np.float32),
                                      np.zeros((1, 1, 4, 4), bool), CFG,
                                      device="cpu")
