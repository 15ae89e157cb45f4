"""Port parity of the command line: ``velo_tpu_torch.cli.main`` against
``velo_tpu.cli.main`` on the same arguments (``--device cpu`` apart).

Each case runs both command lines on the CPU and compares what a user
gets: the ``--json`` line's keys and the pose file, per frame within
5 cm / 0.1 deg (the end-to-end gate of the odometry tests).
"""
import json

import numpy as np
import pytest
import torch

from velo_tpu import cli as jcli
from velo_tpu_torch import cli as tcli
from velo_tpu_torch.io import kitti as tkitti
from test_torch_odometry import _pose_diff

torch.set_num_threads(1)

# The shapes of ``tiny_test_config()`` and the fixture seed of the other
# parity tests.  Narrower scans (16 rings) leave the solve a few dozen
# correspondences, where one flipped LM accept moves a pose by
# centimetres in either package: nothing a 5 cm gate could hold.
_TINY_SET = "l:n_sectors=8,m:edge_capacity=8192+planar_capacity=16384"
SYNTH = ["--synthetic", "--frames", "6", "--rings", "32", "--azimuth", "1024",
         "--seed", "3", "--no-vision", "--json", "--set", _TINY_SET]


def _run(cli_mod, argv, out, capsys):
    """(result dict of the --json line, poses (F,4,4)) of one run."""
    capsys.readouterr()
    extra = ["--device", "cpu"] if cli_mod is tcli else []
    assert cli_mod.main(argv + ["--out", str(out)] + extra) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    name = "synthetic" if "--synthetic" in argv else argv[
        argv.index("--seq") + 1]
    return json.loads(lines[-1]), tkitti.read_poses(
        str(out / f"{name}.txt"))


def _compare(res_t, poses_t, res_j, poses_j, label):
    assert set(res_t) == set(res_j), label
    assert res_t["frames"] == res_j["frames"] == len(poses_t)
    assert poses_t.shape == poses_j.shape
    worst = (0.0, 0.0)
    for f in range(len(poses_t)):
        dt, dr = _pose_diff(poses_t[f], poses_j[f])
        worst = (max(worst[0], dt), max(worst[1], dr))
    print(f"{label}: worst frame {worst[0]:.5f} m, {worst[1]:.5f} deg; "
          f"ATE {res_t.get('ate_rmse_m')} (JAX {res_j.get('ate_rmse_m')})")
    assert worst[0] < 0.05 and worst[1] < 0.1, (label, worst)


@pytest.mark.parametrize("flags", [
    [],
    ["--fast"],
    ["--no-prebin"],
    ["--smooth", "--smooth-window", "2", "--smooth-passes", "1"],
    ["--no-map", "--no-deskew", "--set", _TINY_SET + ",s:lm_iters=3"],
], ids=["plain", "fast", "no-prebin", "smooth", "no-map-no-deskew-set"])
def test_synthetic_against_the_reference(tmp_path, capsys, flags):
    res_j, poses_j = _run(jcli, SYNTH + flags, tmp_path / "jax", capsys)
    res_t, poses_t = _run(tcli, SYNTH + flags, tmp_path / "torch", capsys)
    _compare(res_t, poses_t, res_j, poses_j, " ".join(flags) or "plain")
    assert res_t["ate_rmse_m"] < 0.2


def test_checkpoint_and_resume(tmp_path, capsys):
    """--checkpoint-every writes, --resume continues: the resumed pose file
    is byte for byte the uninterrupted one, and matches the reference's
    resumed run."""
    ck_t, ck_j = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    _, full = _run(tcli, SYNTH, tmp_path / "full", capsys)
    first = [a if a != "6" else "4" for a in SYNTH]
    _run(tcli, first + ["--checkpoint", ck_t, "--checkpoint-every", "4"],
         tmp_path / "first", capsys)
    res_t, resumed = _run(tcli, SYNTH + ["--checkpoint", ck_t, "--resume"],
                          tmp_path / "resumed", capsys)
    assert (tmp_path / "resumed" / "synthetic.txt").read_bytes() == \
        (tmp_path / "full" / "synthetic.txt").read_bytes()
    np.testing.assert_array_equal(resumed, full)

    _run(jcli, first + ["--checkpoint", ck_j, "--checkpoint-every", "4"],
         tmp_path / "jfirst", capsys)
    res_j, resumed_j = _run(jcli, SYNTH + ["--checkpoint", ck_j, "--resume"],
                            tmp_path / "jresumed", capsys)
    _compare(res_t, resumed, res_j, resumed_j, "resume")
    # Each command line resumes from the other's checkpoint.
    _, crossed = _run(tcli, SYNTH + ["--checkpoint", ck_j, "--resume"],
                      tmp_path / "crossed", capsys)
    np.testing.assert_allclose(crossed[:4], resumed_j[:4], atol=1e-6)
    with pytest.raises(FileNotFoundError, match="--resume"):
        tcli.main(SYNTH + ["--checkpoint", str(tmp_path / "none.npz"),
                           "--resume", "--device", "cpu"])


def test_refused_configs_fail_before_any_work(tmp_path):
    """``nn_approx_impl=xla`` runs (one frame); an unknown value raises
    ValueError before any work."""
    ok = tmp_path / "xla"
    argv = [a if a != "6" else "1" for a in SYNTH]  # --frames 1
    assert tcli.main(argv + ["--set", "s:nn_approx_impl=xla", "--out",
                             str(ok), "--device", "cpu"]) == 0
    assert tkitti.read_poses(str(ok / "synthetic.txt")).shape == (1, 4, 4)
    out = tmp_path / "out"
    with pytest.raises(ValueError, match="nn_approx_impl"):
        tcli.main(SYNTH + ["--set", "s:nn_approx_impl=bogus", "--out",
                           str(out), "--device", "cpu"])
    assert not out.exists()


def test_parser_has_every_flag_of_the_reference():
    """Action by action: the same option strings, destination, default,
    type, choices and arity; ``--device`` is the port's only addition."""
    def table(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.type,
                         tuple(a.choices) if a.choices else None, a.nargs,
                         type(a).__name__, a.required)
                for a in parser._actions}

    tj, tt = table(jcli.build_parser()), table(tcli.build_parser())
    assert set(tt) - set(tj) == {"device"}
    assert set(tj) <= set(tt)
    for dest, spec in tj.items():
        assert tt[dest] == spec, dest
    assert tt["device"][1] is None
    groups_j = [sorted(a.dest for a in g._group_actions)
                for g in jcli.build_parser()._mutually_exclusive_groups]
    groups_t = [sorted(a.dest for a in g._group_actions)
                for g in tcli.build_parser()._mutually_exclusive_groups]
    assert groups_t == groups_j


def test_cli_overrides_preset_first_then_set():
    from velo_tpu_torch import config
    args = tcli.build_parser().parse_args(
        ["--synthetic", "--fast", "--set", "s:prior_obs_impl=deferred"])
    cfg = tcli._apply_cli_overrides(config.VeloConfig(), args)
    assert cfg.solver.prior_obs_impl == "deferred"
    args = tcli.build_parser().parse_args(["--synthetic", "--fast"])
    cfg = tcli._apply_cli_overrides(config.VeloConfig(), args)
    assert cfg.solver.prior_obs_impl == "deferred_tail"


def test_without_a_card_main_names_device_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "out"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(SYNTH + ["--out", str(out)])
    assert not out.exists()
