"""The benchmark's voxel-hash configuration ``kitti-hdl64-lidar-hash`` and
its cell ``lidar.hash``, on the CPU:

* the port's ``odometry.run_scan`` with ``nn_engine="hash"`` over a few
  frames of the benchmark's simulated drive, at 16 x 256, against the
  benchmark's plain reference (``benchmarks/reference``, its own eager
  hash step), within the cell's limits;
* the configuration file is ``kitti-hdl64-lidar``'s field for field but
  ``solver.nn_engine`` and ``solver.voxel_occupancy`` (KISS-ICP's 20
  points a voxel), and the cell is ``lidar.replay``'s but its
  configuration.

The file imports no JAX.
"""
import json
from pathlib import Path

import numpy as np
import torch

from benchmarks import drive, harness
from benchmarks.reference import config as rconfig
from benchmarks.reference.lidar import rangeimage as rrangeimage
from benchmarks.reference.pipeline import odometry as rodometry
from velo_tpu_torch import config
from velo_tpu_torch.lidar import rangeimage
from velo_tpu_torch.pipeline import odometry

ROOT = Path(__file__).resolve().parent.parent
FRAMES = 3


def _doc(kind, name):
    return json.loads((ROOT / "benchmarks" / kind / f"{name}.json")
                      .read_text())


def _small(conf):
    """The configuration at 16 x 256 with the tiny preset's maps, over a
    drive of ``FRAMES`` sweeps."""
    vc = conf["velo_config"]
    vc["lidar"].update(n_rings=16, n_azimuth=256)
    vc["map"].update(edge_capacity=8192, planar_capacity=16384)
    vc["n_max_points"] = 16 * 256 * 2
    conf["sequence_frames"] = FRAMES
    return conf


def test_hash_run_scan_matches_the_plain_reference():
    conf = _small(_doc("configs", "kitti-hdl64-lidar-hash"))
    limits = _doc("workloads", "lidar.hash")["limits"]
    sim = drive.simulate(conf, 2**31 + 17, "cpu")
    cfg = harness.build_config(config, conf["velo_config"])
    assert cfg.solver.nn_engine == "hash"
    binned = [rangeimage.bin_scan_host(s, cfg.lidar) for s in sim.scans]
    grids = torch.from_numpy(np.stack([g for g, _ in binned]))
    masks = torch.from_numpy(np.stack([m for _, m in binned]))
    _, res = odometry.run_scan(odometry.init_carry(cfg, "cpu"), grids,
                               masks, cfg)
    rcfg = harness.build_config(rconfig, conf["velo_config"])
    rbinned = [rrangeimage.bin_scan_host(s, rcfg.lidar) for s in sim.scans]
    with torch.inference_mode():
        ref = rodometry.run(
            torch.from_numpy(np.stack([g for g, _ in rbinned])),
            torch.from_numpy(np.stack([m for _, m in rbinned])), rcfg,
            device="cpu")
    poses = res.T_w.numpy()
    assert poses.shape == ref.shape == (FRAMES, 4, 4)
    assert np.isfinite(poses).all()
    # The drive moves, so equal poses are no identity on both sides.
    assert np.linalg.norm(ref[-1, :3, 3]) > 0.5
    dt, dr = harness.pose_gaps(poses, ref)
    assert dt.max() <= limits["pose_gap_m"], dt
    assert dr.max() <= limits["rot_gap_deg"], dr


def test_hash_configuration_differs_from_the_dense_one_in_its_engine():
    dense = _doc("configs", "kitti-hdl64-lidar")
    hashed = _doc("configs", "kitti-hdl64-lidar-hash")
    hs, ds = hashed["velo_config"]["solver"], dense["velo_config"]["solver"]
    assert hs.pop("nn_engine") == "hash" and ds.pop("nn_engine") == "dense"
    assert hs.pop("voxel_occupancy") == 20
    assert ds.pop("voxel_occupancy") == 8
    for key in ("velo_config", "drive", "reduced", "sequence_frames"):
        assert hashed[key] == dense[key], key
    for key, value in dense["assumed"].items():
        assert hashed["assumed"][key] == value, key
    dense_cell = _doc("workloads", "lidar.replay")
    hash_cell = _doc("workloads", "lidar.hash")
    assert hash_cell["config"] == "kitti-hdl64-lidar-hash"
    for key in ("traffic", "kind", "params", "limits"):
        assert hash_cell[key] == dense_cell[key], key
    spec = harness.benchmark(ROOT)
    cell, conf_entry = harness.cell(spec, "lidar.hash")
    assert cell["chips"] == 1 and conf_entry["file"].endswith(
        "kitti-hdl64-lidar-hash.json")
