"""The long-drive harness, ``velo_tpu_torch.evaluation.longrun``, against
the reference's ``scripts/longrun.py``, and the step after the local
map's ring buffer wraps.

The reference script is loaded by path.  Its fixture cache is a fixed
``/tmp`` name; here every cache file it would read or write is redirected
into the test's own directory (:func:`_reference`), so both harnesses
read one cached fixture there.  Tolerances:

* fixtures: bitwise equal arrays;
* the map insert that overflows its ring: bitwise equal to JAX's;
* one step from JAX's carry after the map wrapped: 1 cm / 0.05 deg, the
  one-step gate of ``test_torch_odometry.py``;
* the two harnesses end to end: every pose of their ``--dump`` within
  5 cm / 0.1 deg (``scripts/parity_check.py``'s gate), the rows' metres
  within 5 cm and degrees within 0.1 deg, their counts equal.
"""
import dataclasses
import importlib.util
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from velo_tpu import config as jconfig
from velo_tpu.lidar import rangeimage as jri
from velo_tpu.mapping import local_map as jlm
from velo_tpu.pipeline import odometry as jodo
from velo_tpu_torch.evaluation import longrun
from velo_tpu_torch.mapping import local_map as tlm
from velo_tpu_torch.pipeline import odometry as todo

from test_torch_odometry import _pose_diff

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The ring capacities of the reference's own small-map tests: at the tiny
# shapes a frame inserts ~500 edges and 3072 planars, so the edge ring
# wraps in frame 1 and the planar ring overflows within every insert.
SMALL_MAP = "m:edge_capacity=1024+planar_capacity=2048"
SEED = 3  # the odometry tests' fixture seed


def _reference(cache_dir):
    """``scripts/longrun.py`` as a module, its ``/tmp`` cache files read
    and written in ``cache_dir`` instead."""
    spec = importlib.util.spec_from_file_location(
        "reference_longrun", os.path.join(REPO, "scripts", "longrun.py"))
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)

    def moved(path):
        return (os.path.join(cache_dir, os.path.basename(path))
                if str(path).startswith("/tmp/velo_longrun_") else path)

    class Numpy:
        def __getattr__(self, name):
            return getattr(np, name)

        def load(self, path, *a, **kw):
            return np.load(moved(path), *a, **kw)

        def savez_compressed(self, path, **kw):
            return np.savez_compressed(moved(path), **kw)

    class Path:
        def __getattr__(self, name):
            return getattr(os.path, name)

        def exists(self, path):
            return os.path.exists(moved(path))

    class Os:
        path = Path()

        def __getattr__(self, name):
            return getattr(os, name)

    ref.np, ref.os = Numpy(), Os()
    return ref


@pytest.mark.parametrize("kw", [
    {},
    {"distorted": False},
    {"with_images": True, "noise_std": 0.02, "dropout": 0.1},
    {"sixdof": True, "world": "suburban"},
], ids=["canyon", "nodistort", "images-noise-dropout", "sixdof-suburban"])
def test_fixture_equals_reference(tmp_path, kw):
    """Every fixture branch gives the reference's arrays, bit for bit,
    under the reference's cache file name, and reads back equal."""
    args = dict(frames=3, rings=16, az=256, seed=SEED, **kw)
    ours = longrun.get_fixture(cache_dir=str(tmp_path / "port"), **args)
    ref_dir = tmp_path / "ref"
    ref_dir.mkdir()
    theirs = _reference(str(ref_dir)).get_fixture(**args)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(ref_dir)) == [os.path.basename(longrun.fixture_path(
            cache_dir="", **args))]
    again = longrun.get_fixture(cache_dir=str(tmp_path / "port"), **args)
    for a, b, c in zip(ours, theirs, again):
        if b is None:
            assert a is None and c is None
            continue
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(c, b)
    assert (ours[5] is not None) == bool(kw.get("with_images"))
    assert longrun.fixture_digest(ours[0], ours[1]) == \
        longrun.fixture_digest(theirs[0], theirs[1])


def test_simulate_in_workers_equals_in_process(tmp_path):
    """Seeds simulated in spawned worker processes are cached with the
    arrays an in-process simulation gives."""
    kws = [dict(frames=2, rings=16, az=256, seed=s,
                cache_dir=str(tmp_path / "workers")) for s in (SEED, 5)]
    longrun.simulate(kws)
    for kw in kws:
        assert os.path.exists(longrun.fixture_path(**kw))
        cached = longrun.get_fixture(**kw)
        fresh = longrun.get_fixture(**dict(kw, cache_dir=str(tmp_path)))
        for a, b in zip(cached[:5], fresh[:5]):
            np.testing.assert_array_equal(a, b)


def test_runs_on_the_card_by_default(tmp_path, monkeypatch):
    """Without ``--device`` the harness takes the card; without a card it
    raises before it simulates anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        longrun.main(["--frames", "2", "--rings", "16", "--azimuth", "256",
                      "--cache-dir", str(tmp_path)])
    assert not os.listdir(tmp_path)


def test_insert_overflowing_the_ring_keeps_the_last_points():
    """An insert with more valid points than the ring holds keeps the last
    ``C`` of them, as the reference's in-order scatter does, and equals
    JAX's map bit for bit, wrap after wrap."""
    rng = np.random.default_rng(SEED)
    C = 1024
    mj, mt = jlm.empty_map(C), tlm.empty_map(C)
    for n in (3072, 700, 3072, 1500):
        new = rng.uniform(-30, 30, (n, 3)).astype(np.float32)
        valid = rng.random(n) > 0.2
        expect = np.asarray(mt.pts).copy()
        cursor = int(mt.cursor)
        for p in new[valid]:  # the scatter in lane order
            expect[cursor % C] = p
            cursor += 1
        mj = jlm.insert(mj, jnp.asarray(new), jnp.asarray(valid))
        mt = tlm.insert(mt, torch.tensor(new), torch.tensor(valid))
        np.testing.assert_array_equal(mt.pts.numpy(), expect)
        assert int(mt.cursor) == cursor % C
        for a, b in zip(mt, mj):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.fixture(scope="module")
def wrapped():
    """JAX's run of the small-map configuration: the frames, the numpy
    carry entering each frame, and the poses."""
    cfg = jconfig.apply_overrides(dataclasses.replace(
        jconfig.tiny_test_config(), use_vision=False, use_map=True,
        prebin_host=True), SMALL_MAP)
    from velo_tpu.io import fixtures

    scans = fixtures.make_fixture(n_frames=4, n_rings=32, n_azimuth=1024,
                                  with_images=False, seed=SEED).scans
    frames = [jri.bin_scan_host(s, cfg.lidar) for s in scans]
    carry = jodo.init_carry(cfg)
    carries, poses = [], []
    for g, v in frames:
        carries.append(jax.tree.map(np.asarray, carry))
        carry, out = jodo.jit_step(carry, jnp.asarray(g), jnp.asarray(v),
                                   cfg)
        poses.append(np.asarray(out.T_w))
    return cfg, frames, carries, poses


@pytest.mark.parametrize("frame", [2, 3])
def test_step_after_the_map_wrapped(wrapped, frame):
    """One port step from JAX's carry once both rings have wrapped lands
    within the one-step gate of JAX's pose."""
    cfg, frames, carries, poses = wrapped
    tcfg = longrun.variant_cfg(SMALL_MAP, 32, 1024)
    assert (tcfg.map.edge_capacity, tcfg.map.planar_capacity) == (1024, 2048)
    # The points inserted before this frame (each frame's are the next
    # carry's previous-scan features) overran both rings.
    inserted = [int(c.prev_edge_mask.sum()) for c in carries[1:frame + 1]]
    assert sum(inserted) > cfg.map.edge_capacity, inserted
    assert int(carries[1].prev_planar_mask.sum()) > cfg.map.planar_capacity
    carry = todo.carry_from_jax_numpy(carries[frame], "cpu")
    g, v = frames[frame]
    _, out = todo.step(carry, torch.tensor(g), torch.tensor(v), cfg)
    dt, dr = _pose_diff(out.T_w.numpy(), poses[frame])
    print(f"frame {frame}: {dt:.5f} m, {dr:.5f} deg")
    assert dt < 0.01 and dr < 0.05


def test_harness_rows_match_reference(tmp_path, monkeypatch, capsys):
    """Both harnesses on one cached fixture, 4 frames at 32 x 1024, host
    pre-binned, with the small-map variant (both rings wrap): the same
    rows within the end-to-end gate, the dumps' poses within 5 cm / 0.1
    deg, and rows that ``scripts/summarize_runs.py`` reads."""
    flags = ["--frames", "4", "--rings", "32", "--azimuth", "1024",
             "--prebin", "--seeds", str(SEED), "--variants", SMALL_MAP]
    ours = longrun.main(flags + [
        "--device", "cpu", "--cache-dir", str(tmp_path),
        "--dump", str(tmp_path / "port"),
        "--trail", str(tmp_path / "trail.jsonl")])
    ref = _reference(str(tmp_path))
    monkeypatch.setattr(sys, "argv", ["longrun.py", *flags,
                                      "--dump", str(tmp_path / "ref")])
    theirs = ref.main()
    # One cached fixture, two dumps and the trail.
    assert len(os.listdir(tmp_path)) == 4, os.listdir(tmp_path)
    assert len(ours) == len(theirs) == 1
    a, b = ours[0], theirs[0]
    assert set(a) == set(b) | {"frames_per_s"}
    assert (a["variant"], a["seed"]) == (b["variant"], b["seed"])
    assert a["degenerate"] == b["degenerate"]
    for k in ("t_err_pct", "r_err_deg"):  # 32 m: no 100 m segment
        assert math.isnan(a[k]) and math.isnan(b[k])
    for k in ("ate_m", "med_rel_err_m", "max_rel_err_m"):
        assert abs(a[k] - b[k]) < 0.05, (k, a[k], b[k])
    assert abs(a["med_rot_err_deg"] - b["med_rot_err_deg"]) < 0.1

    name = SMALL_MAP.replace(":", "_")
    pd = np.load(tmp_path / f"port_{name}_s{SEED}.npz")
    rd = np.load(tmp_path / f"ref_{name}_s{SEED}.npz")
    assert set(pd.files) == set(rd.files)
    np.testing.assert_array_equal(pd["gt_velo"], rd["gt_velo"])
    for f in range(4):
        dt, dr = _pose_diff(pd["poses_velo"][f], rd["poses_velo"][f])
        print(f"frame {f}: {dt:.5f} m, {dr:.5f} deg")
        assert dt < 0.05 and dr < 0.1

    spec = importlib.util.spec_from_file_location(
        "summarize_runs", os.path.join(REPO, "scripts", "summarize_runs.py"))
    summarize = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(summarize)
    capsys.readouterr()
    summarize.main([str(tmp_path / "trail.jsonl")])
    assert f"{SMALL_MAP}" in capsys.readouterr().out
