"""The command line's solver variants and ``--plot``: ``--batch`` with
each variant through ``--set`` (their batched steps against
single-sequence runs: ``test_torch_batch_variants.py``), and ``--plot``
with and without matplotlib.
"""
import json
import sys

import numpy as np
import pytest
import torch

from velo_tpu_torch import cli as tcli
from velo_tpu_torch.io import kitti as tkitti
from test_torch_cli import SYNTH

torch.set_num_threads(1)


@pytest.mark.parametrize("spec", ["s:ct_sweep=1", "s:deskew_exact_lag=1",
                                  "s:nn_engine=hash"])
def test_batch_runs_the_solver_variants(tmp_path, capsys, spec):
    """``--batch`` takes each solver variant through ``--set``."""
    out = tmp_path / "out"
    assert tcli.main(["--synthetic", "--batch", "2", "--frames", "2",
                      "--rings", "16", "--azimuth", "256", "--no-vision",
                      "--set", spec, "--json", "--out", str(out),
                      "--device", "cpu"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["batch"] == 2 and len(res["sequences"]) == 2
    for b in range(2):
        p = tkitti.read_poses(str(out / f"seq{b:02d}.txt"))
        assert p.shape == (2, 4, 4) and np.isfinite(p).all()


def test_plot_writes_the_plots(tmp_path, capsys):
    out = tmp_path / "out"
    assert tcli.main(["--synthetic", "--frames", "2", "--rings", "16",
                      "--azimuth", "256", "--no-vision", "--plot", "--out",
                      str(out), "--device", "cpu"]) == 0
    assert "plots: " in capsys.readouterr().err
    assert (out / "synthetic_path.png").exists()
    assert (out / "synthetic_errors.png").exists()


def test_plot_without_matplotlib_fails_before_any_work(tmp_path,
                                                      monkeypatch):
    """Where matplotlib is missing (the card's machine), ``--plot`` fails
    with an ImportError naming it before any frame runs."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    out = tmp_path / "out"
    with pytest.raises(ImportError, match="matplotlib"):
        tcli.main(SYNTH + ["--plot", "--out", str(out), "--device", "cpu"])
    assert not out.exists()
