"""The port's evaluation tools: ``plots.plot_trajectory`` (matplotlib,
installed here) and ``profiling.trace``, on the CPU (the stage marks,
spans and counters: ``test_torch_stage_marks.py``)."""
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


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "prof")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "prof" / "trace.json") as f:
        assert json.load(f)["traceEvents"]
