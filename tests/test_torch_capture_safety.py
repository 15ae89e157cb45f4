"""The odometry step does nothing that a CUDA-graph capture refuses.

On the card ``jit_step`` and ``batched_run_scan`` capture the step into
CUDA graphs, and a capture fails on a host sync (``.item()``, a
boolean-mask index, ``nonzero``, ``torch.linalg.inv``'s host check) or on
a host-to-device copy (``torch.tensor(x, device=...)``, a Python scalar
assigned by index).  Here, on the CPU, a dispatch mode watches two frames
of each configuration's step for those operations: the card's capture is
the real test, this one finds a new such op before a chip run does.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from velo_tpu_torch import config as tconfig
from velo_tpu_torch.geom import camera as tcam
from velo_tpu_torch.io import fixtures, kitti
from velo_tpu_torch.kernels import _build
from velo_tpu_torch.lidar import rangeimage as tri
from velo_tpu_torch.pipeline import batch as tbatch
from velo_tpu_torch.pipeline import graphs
from velo_tpu_torch.pipeline import odometry as todo

torch.set_num_threads(1)

SYNCS = {"aten._local_scalar_dense.default", "aten.nonzero.default",
         "aten._linalg_check_errors.default", "aten.masked_select.default",
         "aten.repeat_interleave.Tensor", "aten._unique2.default",
         "aten.unique_consecutive.default"}
# Ops that copy a value tensor into another: a tensor made from Python
# data (lift_fresh) would be a host tensor there.
TAKES_VALUES = {"aten.copy_.default", "aten.index_put_.default",
                "aten.index_put.default", "aten.fill_.Tensor",
                "aten.masked_fill_.Tensor", "aten.masked_fill.Tensor"}
INDEXING = {"aten.index.Tensor", "aten.index_put_.default",
            "aten.index_put.default"}


class HostTraffic(TorchDispatchMode):
    """Records the ops that would sync with, or copy from, the host."""

    def __init__(self):
        super().__init__()
        self.found, self._lifted = [], set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        bad = name in SYNCS
        if name == "aten.lift_fresh.default":
            out = func(*args, **(kwargs or {}))
            self._lifted.add(id(out))
            return out
        if name in TAKES_VALUES:
            bad = bad or any(id(a) in self._lifted for a in args)
        if name in INDEXING:
            bad = bad or any(i is not None and i.dtype == torch.bool
                             for i in args[1])
        if bad:
            self.found.append(name)
        return func(*args, **(kwargs or {}))


BASE = dataclasses.replace(tconfig.tiny_test_config(), use_map=True,
                           prebin_host=True)
LIDAR = dataclasses.replace(BASE, use_vision=False)
FUSED = dataclasses.replace(BASE, use_vision=True, vision=dataclasses.replace(
    BASE.vision, klt_impl="pallas"))
CONFIGS = {
    "lidar": LIDAR,
    "fused-pallas": FUSED,
    "ct-fused": tconfig.apply_overrides(FUSED, "s:ct_sweep=1"),
    "exact-lag": tconfig.apply_overrides(LIDAR, "s:deskew_exact_lag=1"),
    "hash": tconfig.apply_overrides(LIDAR, "s:nn_engine=hash"),
    "deferred-tail": tconfig.apply_overrides(
        LIDAR, "s:prior_obs_impl=deferred_tail,s:degen_rel_min=0.05"),
    "no-prebin": dataclasses.replace(LIDAR, prebin_host=False),
    "matmul": dataclasses.replace(FUSED, vision=dataclasses.replace(
        FUSED.vision, klt_impl="matmul")),
    "window": dataclasses.replace(FUSED, vision=dataclasses.replace(
        FUSED.vision, klt_impl="window")),
    "nn-xla": tconfig.apply_overrides(LIDAR, "s:nn_approx_impl=xla"),
}


@pytest.fixture(scope="module")
def drive():
    return fixtures.make_fixture(n_frames=2, n_rings=BASE.lidar.n_rings,
                                 n_azimuth=BASE.lidar.n_azimuth,
                                 height=BASE.vision.height,
                                 width=BASE.vision.width, seed=3)


def _frames(fx, cfg):
    for scan, img in zip(fx.scans, fx.images):
        grid = (tri.bin_scan_host(scan, cfg.lidar) if cfg.prebin_host
                else kitti.pad_scan(scan, cfg.n_max_points))
        yield (torch.tensor(grid[0]), torch.tensor(grid[1]),
               torch.tensor(img) if cfg.use_vision else None)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_step_has_no_host_sync_or_copy(drive, name):
    cfg = CONFIGS[name]
    cam = tcam.from_numpy(drive.P, drive.T_cam_velo, cfg.vision.width,
                          cfg.vision.height, "cpu")
    carry = todo.init_carry(cfg, "cpu")
    watch = HostTraffic()
    for scan, mask, img in _frames(drive, cfg):
        with watch:
            carry, _ = todo.step(carry, scan, mask, cfg, image=img,
                                 cam=cam if cfg.use_vision else None)
    assert watch.found == []


def test_batched_step_has_no_host_sync_or_copy(drive):
    cfg = FUSED
    cam = tcam.from_numpy(drive.P, drive.T_cam_velo, cfg.vision.width,
                          cfg.vision.height, "cpu")
    step = tbatch.batched_step(cfg, cam)
    carry = tbatch.broadcast_carry(todo.init_carry(cfg, "cpu"), 2)
    watch = HostTraffic()
    for scan, mask, img in _frames(drive, cfg):
        with watch:
            carry, _ = step(carry, *(torch.stack([x, x])
                                     for x in (scan, mask, img)))
    assert watch.found == []


class _Built(Exception):
    """Stops a capture once its libraries are asked for."""


@pytest.mark.parametrize("name,libraries", [
    ("lidar", {"dist_topk", "klt_l0", "lm_lidar", "corr_fit",
               "stage_mark"}),
    ("fused-pallas", {"dist_topk", "klt_l0", "lm_lidar", "lm_joint",
                      "corr_fit", "stage_mark"})])
def test_first_capture_builds_the_step_libraries(name, libraries,
                                                 monkeypatch):
    """What a step builds before its first capture: every kernel a step
    may launch and the stage marks, and lm_joint (the slowest build) only
    for a step with images."""
    built = []

    def build_all(names):
        built.extend(names)
        raise _Built

    monkeypatch.setattr(_build, "build_all", build_all)
    cfg = CONFIGS[name]
    carry = todo.init_carry(cfg, "cpu")
    try:
        with pytest.raises(_Built):
            graphs.runner("odometry.step", cfg, None, carry, (),
                          lambda fh: ())(carry)
    finally:
        graphs.release()
    assert len(built) == len(libraries) and set(built) == libraries


def test_the_watch_sees_what_a_capture_refuses():
    x = torch.arange(6.0)
    watch = HostTraffic()
    with watch:
        x[x > 2.0].sum().item()
        y = torch.zeros(6)
        y[torch.tensor([1, 2])] = True
        torch.linalg.inv(torch.eye(3))
    assert watch.found == ["aten.index.Tensor",
                           "aten._local_scalar_dense.default",
                           "aten.index_put_.default",
                           "aten._linalg_check_errors.default"]
    assert np.isfinite(y.numpy()).all()
