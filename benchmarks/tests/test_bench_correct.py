"""The comparison that decides ``correct``, shown to fail: the control
(the reference one precision lower, in the program's place) and the
faults the cells can have, planted under a whole run of the harness on the
CPU at a small size (the harness's look for a card skipped)."""
import json

import pytest
import torch

from benchmarks import control, harness, run
from benchmarks.tests.conftest import tiny

CELLS = ["lidar.replay", "lidar.online", "fused.replay", "fused.fleet8"]


def _conf(cell):
    spec = harness.benchmark()
    _, entry = harness.cell(spec, cell)
    conf, work = harness.config_file(entry), harness.workload_file(cell)
    tiny(conf, work)
    return conf, work


def _run(cell, capsys, seed=11):
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   "3", "--trace", "0"], device="cpu", adjust=tiny)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", ["lidar.replay", "fused.replay",
                                  "fused.fleet8"])
def test_control_fails_the_limits(cell):
    from benchmarks import drive

    conf, work = _conf(cell)
    sim = drive.simulate(conf, 5, "cpu")
    row = control.judge(conf, work, sim, torch.device("cpu"))
    assert not row["correct"] and row["failed"] >= 1, row["checks"]
    from benchmarks.reference import fp
    assert fp.F64 == torch.float64


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, capsys):
    out = _run(cell, capsys)
    assert out["correct"] and out["failed"] == 0, out["checks"]
    assert out["checks"]["poses_compared"]["value"] >= 1


def _unchanged(step):
    """A step that returns its state unchanged (the pose never moves)."""
    def fault(carry, scan, scan_mask, cfg, **kw):
        new, out = step(carry, scan, scan_mask, cfg, **kw)
        return carry._replace(frame_host=carry.frame_host + 1), \
            out._replace(T_w=carry.T_w.clone())
    return fault


def _altered(step):
    """A pose altered where it is produced: 1 mm along x on every frame
    after the first."""
    def fault(carry, scan, scan_mask, cfg, **kw):
        new, out = step(carry, scan, scan_mask, cfg, **kw)
        if carry.frame_host >= 1:
            T = out.T_w.clone()
            T[0, 3] += 1e-3
            out = out._replace(T_w=T)
        return new, out
    return fault


def _half_left_out(step):
    """Half of each sweep's points left out (every other ring)."""
    def fault(carry, scan, scan_mask, cfg, **kw):
        mask = scan_mask.clone()
        mask[1::2] = False
        return step(carry, scan, mask, cfg, **kw)
    return fault


@pytest.mark.parametrize("fault", [_unchanged, _altered, _half_left_out])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(cell, fault, capsys,
                                            monkeypatch):
    from velo_tpu_torch.pipeline import odometry

    monkeypatch.setattr(odometry, "step", fault(odometry.step))
    out = _run(cell, capsys)
    assert not out["correct"] and out["failed"] >= 1, out["checks"]
