"""The port's own copies of the reference's framework-free modules
(``config``, ``io/fixtures``, ``evaluation/kitti_metric``, ``io/kitti``,
``native/veloio.cpp``, ``evaluation/plots``) held equal to their
originals: the two packages share one tuning surface, one drive
simulator, one drift metric, one set of KITTI file formats, one native
scan loader and one set of plots without the port importing ``velo_tpu``.
"""
import ast
import dataclasses
import inspect
from pathlib import Path

import numpy as np
import pytest

import velo_tpu_torch
from velo_tpu import config as jconfig
from velo_tpu.evaluation import kitti_metric as jmetric
from velo_tpu.io import fixtures as jfix
from velo_tpu.io import kitti as jkitti
from velo_tpu_torch import config as tconfig
from velo_tpu_torch.evaluation import kitti_metric as tmetric
from velo_tpu_torch.io import fixtures as tfix
from velo_tpu_torch.io import kitti as tkitti

_CONFIGS = ["LidarConfig", "VisionConfig", "SolverConfig", "MapConfig",
            "VeloConfig"]


def _as_dict(cfg):
    """A config as nested (field -> (type, value)) dicts."""
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        out[f.name] = (str(f.type),
                       _as_dict(v) if dataclasses.is_dataclass(v) else v)
    return out


@pytest.mark.parametrize("name", _CONFIGS)
def test_config_dataclasses_equal(name):
    j, t = getattr(jconfig, name), getattr(tconfig, name)
    assert t.__dataclass_params__.frozen and j.__dataclass_params__.frozen
    fj = [(f.name, str(f.type)) for f in dataclasses.fields(j)]
    ft = [(f.name, str(f.type)) for f in dataclasses.fields(t)]
    assert ft == fj
    # Defaults, recursively through the nested sub-configs.
    assert _as_dict(t()) == _as_dict(j())
    # Nested sub-configs are the copy's own classes.
    for f in dataclasses.fields(t):
        v = getattr(t(), f.name)
        if dataclasses.is_dataclass(v):
            assert type(v) is getattr(tconfig, type(v).__name__)


def test_tiny_config_presets_and_overrides_equal():
    assert _as_dict(tconfig.tiny_test_config()) == \
        _as_dict(jconfig.tiny_test_config())
    assert tconfig.lidar_only().use_vision is False
    assert _as_dict(tconfig.lidar_only()) == _as_dict(jconfig.lidar_only())
    assert tconfig.FAST_PRESET == jconfig.FAST_PRESET
    spec = ("v:klt_iters_fb=2+klt_impl=pallas,s:lm_iters=3+ct_sweep=1 "
            "l:n_rings=16+edge_min_curv=0.25 m:maintain_every=3")
    for spec in (spec, tconfig.FAST_PRESET):
        assert _as_dict(tconfig.apply_overrides(tconfig.VeloConfig(), spec)) \
            == _as_dict(jconfig.apply_overrides(jconfig.VeloConfig(), spec))
    assert velo_tpu_torch.config is tconfig


def test_make_fixture_bitwise_equal(monkeypatch):
    # The reference reads VELO_FIX_ACCEL; the copy has no such switch.
    monkeypatch.delenv("VELO_FIX_ACCEL", raising=False)
    kw = dict(n_frames=2, n_rings=16, n_azimuth=256, height=64, width=192,
              seed=1)
    a, b = tfix.make_fixture(**kw), jfix.make_fixture(**kw)
    assert len(a.scans) == len(b.scans) == 2
    for x, y in zip(a.scans, b.scans):
        np.testing.assert_array_equal(x, y)
    for name in ("images", "gt_poses_velo", "gt_poses_cam", "P",
                 "T_cam_velo", "times"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert velo_tpu_torch.fixtures is tfix


def test_evaluate_trajectory_equal():
    """A 1300-pose drive (130 m) with a drifting estimate: every number of
    the KITTI metric equal."""
    rng = np.random.default_rng(9)
    n = 1300
    yaw = np.cumsum(rng.normal(0, 0.002, n))
    xy = np.cumsum(0.1 * np.stack([np.cos(yaw), np.sin(yaw)], 1), 0)
    gt = np.tile(np.eye(4), (n, 1, 1))
    gt[:, 0, 0], gt[:, 0, 1] = np.cos(yaw), -np.sin(yaw)
    gt[:, 1, 0], gt[:, 1, 1] = np.sin(yaw), np.cos(yaw)
    gt[:, :2, 3] = xy
    est = gt.copy()
    est[:, :3, 3] *= 1.01
    est[:, 2, 3] += np.linspace(0, 0.5, n)
    rj = jmetric.evaluate_trajectory(est, gt)
    rt = tmetric.evaluate_trajectory(est, gt)
    assert rj.n_segments > 0
    assert dataclasses.asdict(rt) == dataclasses.asdict(rj)
    assert velo_tpu_torch.kitti_metric is tmetric


def _code(obj) -> str:
    """The syntax tree of a function or class, docstrings left out."""
    tree = ast.parse(inspect.getsource(obj))
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


@pytest.mark.parametrize("name", [
    "read_velodyne_bin", "read_calib", "read_times", "read_poses",
    "write_poses", "pad_scan", "ImagePrefetcher", "KittiSequence"])
def test_kitti_io_copied_statement_for_statement(name):
    """Code equal (docstrings apart), so the two cannot drift apart
    silently.  ``read_image_gray`` is the one function that differs (the
    port decodes PNG itself, the reference through OpenCV):
    ``test_torch_kitti_io.py`` holds its result equal instead."""
    assert _code(getattr(tkitti, name)) == _code(getattr(jkitti, name))


def test_kitti_io_copy_has_the_same_names():
    def public(mod):
        return sorted(n for n, v in vars(mod).items()
                      if not n.startswith("_") and getattr(
                          v, "__module__", None) == mod.__name__)
    assert public(tkitti) == public(jkitti)


def test_native_loader_source_byte_equal():
    repo = Path(__file__).resolve().parent.parent
    assert (repo / "velo_tpu_torch" / "native" / "veloio.cpp").read_bytes() \
        == (repo / "velo_tpu" / "native" / "veloio.cpp").read_bytes()


def test_plot_trajectory_source_equal_but_its_import():
    """Source-equal, apart from the line that imports the port's own
    ``kitti_metric``."""
    from velo_tpu.evaluation import plots as jplots
    from velo_tpu_torch.evaluation import plots as tplots

    theirs = inspect.getsource(jplots.plot_trajectory)
    ours = inspect.getsource(tplots.plot_trajectory)
    line = "    from velo_tpu.evaluation import kitti_metric\n"
    assert theirs.count(line) == 1
    assert ours == theirs.replace(line, line.replace("velo_tpu.",
                                                     "velo_tpu_torch."))

