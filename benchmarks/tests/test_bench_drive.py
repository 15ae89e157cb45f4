"""The frozen drive simulator equals the program's generator it was
copied from: numpy on the CPU, the raycaster on a torch device (the CPU
here, the card with ``-m cuda``)."""
import numpy as np
import pytest

from benchmarks.drive import fixtures as frozen

KW = dict(n_frames=3, n_rings=16, n_azimuth=256, height=64, width=192,
          noise_std=0.02, seed=2**31 + 7)


def _equal(a, b):
    assert len(a.scans) == len(b.scans)
    for x, y in zip(a.scans, b.scans):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a.images, b.images)
    np.testing.assert_array_equal(a.gt_poses_velo, b.gt_poses_velo)
    np.testing.assert_array_equal(a.P, b.P)


def test_numpy_drive_equals_the_programs(monkeypatch):
    from velo_tpu_torch.io import fixtures

    monkeypatch.delenv("VELO_FIX_ACCEL", raising=False)
    _equal(frozen.make_fixture(**KW), fixtures.make_fixture(**KW))


def _accel(monkeypatch, device):
    from velo_tpu_torch.io import fixtures

    monkeypatch.setenv("VELO_FIX_ACCEL", "1")
    _equal(frozen.make_fixture(**KW, device=device),
           fixtures.make_fixture(**KW, device=device))


def test_raycast_drive_equals_the_programs_on_the_cpu(monkeypatch):
    _accel(monkeypatch, "cpu")


@pytest.mark.cuda
def test_raycast_drive_equals_the_programs_on_the_card(monkeypatch, card):
    _accel(monkeypatch, card)
