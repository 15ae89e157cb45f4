"""Port parity of the command line on a KITTI-layout directory:
``velo_tpu_torch.cli.main --kitti-root`` against ``velo_tpu.cli.main`` on a
sequence that ``velo_tpu_torch.io.fake_kitti`` exports, and the proof that
such a run loads nothing of JAX, OpenCV or the reference package.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from velo_tpu import cli as jcli
from velo_tpu_torch import cli as tcli
from velo_tpu_torch.io import fake_kitti
from velo_tpu_torch.io import kitti as tkitti
from test_torch_cli import _compare, _run

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The KITTI branch builds its config from the defaults (64 x 2048 LiDAR,
# 192 x 640 images); --set cuts it to a size for the CPU, on a sequence
# exported at that size.
_KITTI_SET = ("l:n_rings=16+n_azimuth=512+n_sectors=8,"
              "v:height=64+width=192+k_tracks=64+grid_cols=12,"
              "m:edge_capacity=4096+planar_capacity=8192")


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti")
    fake_kitti.export(str(root), frames=3, rings=16, azimuth=512, height=64,
                      width=192, seed=2)
    return root


@pytest.mark.parametrize("flags", [[], ["--no-vision", "--no-prebin"]],
                         ids=["fused", "lidar-no-prebin"])
def test_kitti_layout_against_the_reference(tmp_path, capsys, kitti_root,
                                            flags):
    argv = ["--kitti-root", str(kitti_root), "--seq", "00", "--frames", "0",
            "--json", "--set", _KITTI_SET] + flags
    res_j, poses_j = _run(jcli, argv, tmp_path / "jax", capsys)
    res_t, poses_t = _run(tcli, argv, tmp_path / "torch", capsys)
    assert len(poses_t) == 3
    _compare(res_t, poses_t, res_j, poses_j, "kitti " + " ".join(flags))
    # The reference's own gate on this path: relative per-frame motion
    # within 10 cm of the exported ground truth in the median.
    gt = tkitti.read_poses(str(kitti_root / "poses" / "00.txt"))
    rel_e = np.einsum("fij,fjk->fik", np.linalg.inv(poses_t[:-1]),
                      poses_t[1:])
    rel_g = np.einsum("fij,fjk->fik", np.linalg.inv(gt[:-1]), gt[1:])
    err = np.linalg.norm(rel_e[:, :3, 3] - rel_g[:, :3, 3], axis=1)
    assert np.median(err) < 0.10, err


def test_cli_run_leaves_jax_and_cv2_out(tmp_path):
    """A subprocess exports a sequence and runs the command line on it,
    fused, through ``python -m velo_tpu_torch``'s entry: no jax, no cv2, no
    matplotlib and no file of ``velo_tpu/`` gets loaded."""
    code = (
        "import os, sys\n"
        "from velo_tpu_torch.io import fake_kitti\n"
        "from velo_tpu_torch import cli\n"
        "root, out = sys.argv[1], sys.argv[2]\n"
        "fake_kitti.export(root, frames=2, rings=16, azimuth=512, "
        "height=64, width=192, seed=2)\n"
        "rc = cli.main(['--kitti-root', root, '--frames', '2', '--out', out,"
        " '--device', 'cpu', '--smooth', '--smooth-window', '1', "
        "'--smooth-passes', '1', '--checkpoint', out + '/ck.npz', "
        "'--checkpoint-every', '1', '--set', %r])\n"
        "assert rc == 0\n"
        "ref = os.path.join(%r, 'velo_tpu') + os.sep\n"
        "bad = [m for m, mod in list(sys.modules.items()) if "
        "m.split('.')[0] in ('jax', 'jaxlib', 'velo_tpu', 'cv2', "
        "'matplotlib') or "
        "(getattr(mod, '__file__', None) or '').startswith(ref)]\n"
        "assert not bad, bad\n"
        "print('ok')\n") % (_KITTI_SET, REPO)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", code, str(tmp_path / "kitti"),
         str(tmp_path / "out")], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "ok"
    assert (tmp_path / "out" / "00.txt").exists()


def test_module_entry_point(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "velo_tpu_torch", "--help"], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 0
    assert "--kitti-root" in proc.stdout and "--device" in proc.stdout
