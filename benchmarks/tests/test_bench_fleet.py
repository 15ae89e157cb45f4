"""The fleet cell and the harness's one drive and one reference per
sequence: lane i's drive from seed + i, each sequence judged against its
own drive's reference, planted lane faults caught, the single-sequence
cells compared as before; the fleet's and ``lm_lidar``'s readers."""
import json

import numpy as np
import pytest

from benchmarks import drive, harness, run
from benchmarks.tests.conftest import tiny

FLEET = "fused.fleet8"
SINGLE = ["lidar.replay", "lidar.online", "fused.replay"]


def _docs(cell):
    _, entry = harness.cell(harness.benchmark(), cell)
    conf, work = harness.config_file(entry), harness.workload_file(cell)
    tiny(conf, work)
    return conf, work


def _fleet(conf, work):
    """Two lanes; one chunk of 4 steps covers every compared frame."""
    tiny(conf, work)
    work["params"].update(chunk_frames=4)


def _run(capsys, cell=FLEET, adjust=_fleet, seed=11):
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   "0.5", "--trace", "0"], device="cpu", adjust=adjust)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_fleet_workload_names_its_lanes():
    doc = harness.workload_file(FLEET)
    assert doc["kind"] == "fleet" and doc["params"]["sequences"] == 8
    assert doc["params"]["compare_frames"] == 6
    for cell in SINGLE:
        assert "sequences" not in harness.workload_file(cell)["params"]


def test_lane_i_drives_from_seed_plus_i():
    conf, _ = _docs(FLEET)
    seed = 2**31 + 5
    lanes = run.simulate_drives(conf, seed, 2, "cpu")
    for i, lane in enumerate(lanes):
        alone = drive.simulate(conf, seed + i, "cpu")
        for a, b in zip(lane.scans, alone.scans):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(lane.images, alone.images)
        np.testing.assert_array_equal(lane.gt_poses_velo, alone.gt_poses_velo)
    assert not np.array_equal(lanes[0].gt_poses_velo, lanes[1].gt_poses_velo)


def test_fleet_run_compares_every_lane(capsys):
    out = _run(capsys)
    assert out["correct"] and out["failed"] == 0, out["checks"]
    _, work = _docs(FLEET)
    assert out["checks"]["poses_compared"]["value"] == 2 * work["params"][
        "compare_frames"]
    assert out["attempted"] % 2 == 0
    assert out["metrics"]["frames_per_s"]["value"] > 0


def _swapped(batched_run_scan):
    """The program's batch entry with the two lanes' poses swapped."""
    def entry(cfg, cam=None):
        inner = batched_run_scan(cfg, cam)

        def fault(bcarry, bscans, bmasks, bimages=None):
            bcarry, res = inner(bcarry, bscans, bmasks, bimages)
            return bcarry, res._replace(T_w=res.T_w.flip(0))
        return fault
    return entry


def _shared(batched_run_scan):
    """The program's batch entry handing lane 1 lane 0's drive: a per-lane
    input read at batch stride 0."""
    def entry(cfg, cam=None):
        inner = batched_run_scan(cfg, cam)

        def fault(bcarry, bscans, bmasks, bimages=None):
            def first(x):
                return None if x is None else x[:1].expand_as(x)
            return inner(bcarry, first(bscans), first(bmasks), first(bimages))
        return fault
    return entry


@pytest.mark.parametrize("fault", [None, _swapped, _shared])
def test_a_lane_fault_is_not_correct(fault, capsys, monkeypatch):
    from velo_tpu_torch.pipeline import batch

    if fault is not None:
        monkeypatch.setattr(batch, "batched_run_scan",
                            fault(batch.batched_run_scan))
    out = _run(capsys)
    if fault is None:
        assert out["correct"] and out["failed"] == 0, out["checks"]
    else:
        assert not out["correct"] and out["failed"] >= 1, out["checks"]
        assert out["checks"]["pose_gap_m"]["value"] > 1e-4


@pytest.mark.parametrize("cell", SINGLE)
def test_single_sequence_cells_compare_as_before(cell, capsys, monkeypatch):
    """One drive, the seed's own, and the single-reference comparison."""
    calls, drives = [], []
    compare, simulate = harness.compare, run.simulate_drives

    def spy(sequences, reference, limits):
        calls.append((sequences, reference, limits))
        return compare(sequences, reference, limits)

    def spy_drives(conf, seed, lanes, device):
        drives.append((seed, lanes))
        return simulate(conf, seed, lanes, device)

    monkeypatch.setattr(harness, "compare", spy)
    monkeypatch.setattr(run, "simulate_drives", spy_drives)
    out = _run(capsys, cell, tiny, seed=13)
    assert drives == [(13, 1)]
    (sequences, refs, limits), = calls
    assert len(refs) == 1
    assert all(isinstance(s, np.ndarray) for s in sequences)
    assert out["checks"] == compare(sequences, refs[0], limits)[0]
    assert out["correct"]


def test_compare_holds_each_sequence_against_its_own_drive():
    eye = np.tile(np.eye(4), (3, 1, 1))
    moved = eye.copy()
    moved[1:, 0, 3] = 0.5
    limits = {"pose_gap_m": 1e-4, "rot_gap_deg": 5e-4}
    checks, failed = harness.compare([(0, eye), (1, moved)], [eye, moved],
                                     limits)
    assert failed == 0 and harness.checks_pass(checks)
    assert checks["poses_compared"]["value"] == 6
    checks, failed = harness.compare([(0, moved), (1, eye)], [eye, moved],
                                     limits)
    assert failed == 4 and not harness.checks_pass(checks)
    # A bare array is drive 0's; one reference is drive 0's.
    assert harness.compare([eye], eye, limits) == harness.compare(
        [(0, eye)], [eye], limits)


def _trace(steps_marked, kernels_per_step, frames):
    device = [("spin_kernel", 0, 10)]
    t = 20
    for _ in range(steps_marked):
        for j in range(kernels_per_step - 1):
            device.append((f"k{j}", t, 1))
            t += 2
        device.append(("velo_stage_end", t, 1))
        t += 2
    device.append(("Memcpy DtoH", t, 1))
    device.append(("spin_kernel", t + 5, 10))
    return harness.trace_of(device, [], 1.0, frames)


def _read(name, run_):
    return harness.plugin("metrics", name).read(run_)


def test_kernels_per_step_counts_the_steps_by_their_end_marks():
    trace = _trace(3, 50, 24)
    assert _read("kernels_per_step.fleet",
                 {"kind": "fleet", "trace": trace}) == 50
    # More steps in the trace than enqueued read the same.
    assert _read("kernels_per_step.fleet",
                 {"kind": "fleet", "trace": _trace(4, 50, 24)}) == 50
    assert _read("kernels_per_step.fleet",
                 {"kind": "replay", "trace": trace}) is None
    assert _read("kernels_per_step.fleet",
                 {"kind": "fleet", "trace": None}) is None
    assert _read("kernels_per_step.fleet",
                 {"kind": "fleet", "trace": _trace(0, 50, 24)}) is None


def test_frames_per_s_reads_the_fleet_aggregate():
    got = {kind: _read("frames_per_s", {"kind": kind, "frames": 80,
                                        "window_s": 4.0})
           for kind in ("replay", "fleet", "online")}
    assert got == {"replay": 20.0, "fleet": 20.0, "online": None}


@pytest.mark.parametrize("config, solves", [("kitti-hdl64-lidar", 9),
                                            ("kitti-hdl64-fused", 3)])
def test_lm_lidar_work_per_frame(config, solves):
    import velo_tpu_torch
    from benchmarks import roofline
    from benchmarks.roofline import lm_lidar

    spec = harness.benchmark()
    entry = next(c for c in spec["configs"] if c["name"] == config)
    cfg = harness.build_config(velo_tpu_torch.config,
                               harness.config_file(entry)["velo_config"])
    calls = lm_lidar.frame_calls(cfg)
    assert sum(n for n, _ in calls) == solves
    # chip_smoke.py's lm_lidar bound: 1,511,424 float64 operations a
    # solve; 112,873 B scan-to-map, 108,777 B scan-to-scan.
    it = cfg.solver.lm_iters
    assert lm_lidar.call_work(1024, 2048, True, True, it) == (112873,
                                                              1511424)
    assert lm_lidar.call_work(1024, 2048, False, True, it) == (108777,
                                                               1511424)
    assert lm_lidar.frame_least_seconds(cfg) == pytest.approx(
        solves * 1511424 / roofline.FP64_FLOP_S)
    assert roofline.least_seconds(0, 67e12) == pytest.approx(1.0)
    fields = harness.config_file(entry)["velo_config"]
    fields["solver"]["prior_obs_impl"] = "deferred"
    off = harness.build_config(velo_tpu_torch.config, fields)
    assert lm_lidar.frame_calls(off) == []


def test_lm_lidar_roofline_reads_the_kernel():
    import velo_tpu_torch
    from benchmarks.roofline import lm_lidar

    spec = harness.benchmark()
    entry = next(c for c in spec["configs"]
                 if c["name"] == "kitti-hdl64-lidar")
    cfg = harness.build_config(velo_tpu_torch.config,
                               harness.config_file(entry)["velo_config"])
    device = [("spin_kernel", 0, 10),
              ("_anonymous_namespace_::lm_lidar_kernel_LmArgs_", 20, 1000),
              ("spin_kernel", 2000, 10)]
    trace = harness.trace_of(device, [], 1.0, 2)
    want = 100.0 * 2 * lm_lidar.frame_least_seconds(cfg) / 1e-6
    assert _read("lm_lidar_roofline", {"trace": trace, "cfg": cfg}) == \
        pytest.approx(want)
    assert _read("lm_lidar_roofline", {"trace": None, "cfg": cfg}) is None
