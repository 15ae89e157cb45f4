"""The solver variants in the batch mode (config 5), on the CPU:
``ct_sweep`` (fused, ``klt_impl="pallas"``) and ``deskew_exact_lag`` run
as one ``torch.func.vmap``-ped step per frame with functorch's
per-sample fallback off (an operation without a batching rule raises
instead of looping), each sequence bitwise equal to its own
``odometry.run_sequence`` (``nn_engine="hash"``:
``test_torch_voxel_hash.py``).  The command line's ``--batch`` with
each of them through ``--set``: ``test_torch_cli_variants.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from velo_tpu_torch import config as tconfig
from velo_tpu_torch.geom import camera as tcam
from velo_tpu_torch.io import fixtures
from velo_tpu_torch.lidar import rangeimage as ri
from velo_tpu_torch.pipeline import batch, odometry

torch.set_num_threads(1)

SEEDS = (100, 101)  # the batch mode's seeds, 100 + b
BASE = tconfig.tiny_test_config()
N_FRAMES = 3  # exact lag acts from frame 2 on, the depth tracks too
VARIANTS = {  # (override, fused)
    "ct_sweep": ("s:ct_sweep=1", True),
    "exact_lag": ("s:deskew_exact_lag=1", False),
}


@pytest.fixture
def no_vmap_fallback():
    torch._C._functorch._set_vmap_fallback_enabled(False)
    yield
    torch._C._functorch._set_vmap_fallback_enabled(True)


@pytest.fixture(scope="module")
def drives():
    vc = BASE.vision
    return [fixtures.make_fixture(
        n_frames=N_FRAMES, n_rings=BASE.lidar.n_rings,
        n_azimuth=BASE.lidar.n_azimuth, height=vc.height, width=vc.width,
        seed=s) for s in SEEDS]


def batched_equals_single_runs(drives, spec, fused):
    """Run ``drives`` batched under ``spec`` and hold each sequence bitwise
    against its own single run."""
    cfg = tconfig.apply_overrides(dataclasses.replace(
        BASE, use_vision=fused, prebin_host=True,
        vision=dataclasses.replace(BASE.vision, klt_impl="pallas")), spec)
    per_seq = [[ri.bin_scan_host(s, cfg.lidar) + ((fx.images[i],) if fused
                                                  else ())
                for i, s in enumerate(fx.scans)] for fx in drives]
    scans = np.stack([np.stack([f[0] for f in fr]) for fr in per_seq])
    masks = np.stack([np.stack([f[1] for f in fr]) for fr in per_seq])
    images = cam = None
    if fused:
        images = np.stack([fx.images for fx in drives])
        cam = tcam.from_numpy(drives[0].P, drives[0].T_cam_velo,
                              cfg.vision.width, cfg.vision.height, "cpu")
    poses, diag = batch.run_sequences(scans, masks, cfg, images=images,
                                      cam=cam, device="cpu")
    assert poses.shape == (len(SEEDS), N_FRAMES, 4, 4)
    for b, frames in enumerate(per_seq):
        p1, d1, _ = odometry.run_sequence(frames, cfg, device="cpu", cam=cam)
        assert np.array_equal(poses[b], p1), (spec, b)
        for k, v in d1.items():
            assert np.array_equal(diag[k][b], v), (spec, b, k)
    if fused:
        assert (diag["n_depth"][:, -1] > 0).all()  # the visual blocks ran


@pytest.mark.parametrize("name", list(VARIANTS))
def test_variant_batched_equals_single_runs(drives, no_vmap_fallback, name):
    batched_equals_single_runs(drives, *VARIANTS[name])
