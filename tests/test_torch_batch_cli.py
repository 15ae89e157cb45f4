"""Port parity of config 5 through the command line: ``--batch`` of
``velo_tpu_torch.cli`` against ``velo_tpu.cli`` on the same arguments
(``--device cpu`` apart), LiDAR-only at the shapes of
``tiny_test_config()``.

Both simulate the drives of seeds 100 + b and write ``seq{b:02d}.txt``:
the ``--json`` line must have the same keys, per sequence too, and every
pose of every sequence file must lie within 5 cm / 0.1 deg of the
reference's, the end-to-end gate of the odometry tests.
"""
import json

import numpy as np
import torch

from velo_tpu import cli as jcli
from velo_tpu_torch import cli as tcli
from velo_tpu_torch.io import kitti as tkitti
from test_torch_cli import _TINY_SET
from test_torch_odometry import _pose_diff

torch.set_num_threads(1)

BATCH, N_FRAMES = 2, 3
ARGV = ["--synthetic", "--batch", str(BATCH), "--frames", str(N_FRAMES),
        "--rings", "32", "--azimuth", "1024", "--no-vision", "--set",
        _TINY_SET]


def _run(cli_mod, out, capsys):
    capsys.readouterr()
    extra = ["--device", "cpu"] if cli_mod is tcli else []
    assert cli_mod.main(ARGV + ["--out", str(out)] + extra) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return res, [tkitti.read_poses(str(out / f"seq{b:02d}.txt"))
                 for b in range(BATCH)]


def test_lidar_batch_command_line_against_the_reference(tmp_path, capsys):
    res_j, poses_j = _run(jcli, tmp_path / "jax", capsys)
    res_t, poses_t = _run(tcli, tmp_path / "torch", capsys)
    assert set(res_t) == set(res_j)
    assert (res_t["batch"], res_t["frames"], res_t["sharded"],
            res_t["prebin"]) == (BATCH, N_FRAMES, False, True)
    assert [r["seq"] for r in res_t["sequences"]] == list(range(BATCH))
    for rt, rj in zip(res_t["sequences"], res_j["sequences"]):
        assert set(rt) == set(rj)
        assert rt["ate_rmse_m"] < 0.2
    worst = (0.0, 0.0)
    for pt, pj in zip(poses_t, poses_j):
        assert pt.shape == pj.shape == (N_FRAMES, 4, 4)
        assert np.isfinite(pt).all()
        for f in range(N_FRAMES):
            dt, dr = _pose_diff(pt[f], pj[f])
            worst = (max(worst[0], dt), max(worst[1], dr))
    print(f"--batch {BATCH}: worst frame {worst[0]:.5f} m, {worst[1]:.5f} "
          f"deg; agg_fps {res_t['agg_fps']} (JAX {res_j['agg_fps']})")
    assert worst[0] < 0.05 and worst[1] < 0.1, worst
