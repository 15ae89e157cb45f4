"""Tests of the benchmark: ``python -m pytest benchmarks/tests -q`` from the
root of the repository (the card-only ones: ``-m cuda`` on a machine with
one; they skip elsewhere)."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: requires an NVIDIA GPU")


@pytest.fixture
def card():
    """The card, or a skip where there is none (decided here, never at
    import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def tiny(conf, work):
    """A configuration and cell small enough for the CPU: 16 rings x 256
    bins, 128 x 384 images (rendered at 256 x 768 where the drive renders
    at a camera's own size), 5-frame drives, at most 2 sequences."""
    vc = conf["velo_config"]
    vc["lidar"].update(n_rings=16, n_azimuth=256)
    vc["vision"].update(height=128, width=384, k_tracks=128, grid_cols=24)
    vc["solver"].update(hash_capacity=4096)
    vc["map"].update(edge_capacity=8192, planar_capacity=16384)
    vc["n_max_points"] = 16 * 256 * 2
    if "camera" in conf["drive"]:
        conf["drive"]["camera"] = {"height": 256, "width": 768}
    conf["sequence_frames"] = 5
    work["params"].update(chunk_frames=2, warm_frames=2, compare_frames=4,
                          trace_frames=2)
    if "trace_ramp_frames" in work["params"]:
        work["params"]["trace_ramp_frames"] = 1
    if "sequences" in work["params"]:
        work["params"]["sequences"] = 2
