"""The port's evaluation tools: ``plots.plot_trajectory`` (matplotlib,
installed here) and ``profiling.StageTimer`` / ``trace`` / ``FrameLog``,
on the CPU."""
import json
import os

import numpy as np
import torch

from velo_tpu_torch.evaluation import plots, profiling


def test_plot_trajectory_writes_files(tmp_path):
    n = 30
    gt = np.tile(np.eye(4), (n, 1, 1))
    gt[:, 2, 3] = np.linspace(0, 30, n)
    est = gt.copy()
    est[:, 0, 3] += np.linspace(0, 0.1, n)
    written = plots.plot_trajectory(str(tmp_path), "toy", est, gt)
    assert [os.path.basename(p) for p in written] == ["toy_path.png",
                                                      "toy_errors.png"]
    assert all(os.path.getsize(p) > 0 for p in written)
    assert plots.plot_trajectory(str(tmp_path), "est", est) == [
        str(tmp_path / "est_path.png")]


def test_stage_timer_report():
    timer = profiling.StageTimer()
    x = torch.ones(4)
    for _ in range(3):
        with timer.stage("front end", x, (x, [x])):
            x = x + 1
    with timer.stage("solve"):
        pass
    assert timer.counts == {"front end": 3, "solve": 1}
    lines = timer.report().splitlines()
    assert len(lines) == 2
    assert lines[0].startswith("front end") and lines[0].endswith("x3")
    assert "ms/call" in lines[1] and lines[1].endswith("x1")


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "prof")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "prof" / "trace.json") as f:
        assert json.load(f)["traceEvents"]


def test_frame_log_round_trip(tmp_path):
    log = profiling.FrameLog()
    for i in range(3):
        log.add(pose=np.eye(4) * i, n_edge=i, degenerate=i == 1)
    d = log.as_dict()
    assert d["pose"].shape == (3, 4, 4) and d["n_edge"].tolist() == [0, 1, 2]
    log.save(str(tmp_path / "log.npz"))
    back = np.load(tmp_path / "log.npz")
    assert sorted(back.files) == sorted(d)
    for k in d:
        np.testing.assert_array_equal(back[k], d[k])
