"""The stage marks, spans and counters of ``evaluation/profiling`` and the
benchmark's readers of them.

* ``profiling.stage`` inside a capture (a fake capture and mark launcher
  here): a mark on entry, the enclosing stage's mark again after a nested
  stage, the end mark; outside a capture a ``velo.stage.<name>`` range,
  only while a profiler records; the eager step's stages on the CPU; the
  hash engine's ``hash_build`` / ``hash_query`` marks;
* the marks' names: the kernels of ``csrc/stage_mark.cu``, clear of the
  names the benchmark's readers match kernels by;
* ``graphs.CapturedStep``'s host spans and launch counter (a fake graph on
  the CPU), and ``bin_scan_host``'s span;
* ``benchmarks/metrics/_stages.py`` on synthetic traces, the launch
  reader, the hash search's roofline reader, and every stage, launch and
  hash entry of ``BENCHMARK.json`` with its reader;
* on the card only: LiDAR steps at 16 x 256 captured, then replayed under
  the profiler, each mark found as often per frame as the step opens its
  stage, with either correspondence engine.

The file imports no JAX: ``python -m pytest --noconftest -q -m cuda
tests/test_torch_stage_marks.py`` runs the card test where JAX is missing.
"""
import collections
import dataclasses
import json
import re
from pathlib import Path
from typing import NamedTuple

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmarks import harness
from benchmarks.metrics import _stages
from benchmarks.roofline import voxel_hash
from velo_tpu_torch import config
from velo_tpu_torch.evaluation import profiling
from velo_tpu_torch.io import fixtures
from velo_tpu_torch.lidar import rangeimage
from velo_tpu_torch.pipeline import graphs, odometry

ROOT = Path(__file__).resolve().parent.parent
# Marks per LiDAR frame with the benchmark's cadence (refine every frame):
# the solve re-opened after each of its 2 searches, the map refinement
# after each of its 2; fused adds vision_front and vision_book once each.
LIDAR_MARKS = {"lidar_front": 1, "solve": 3, "search": 4, "map_refine": 3,
               "map_update": 1, "carry": 1, "end": 1}
# With the hash engine: 6 grid builds (3 solves x edge and planar) and 18
# queries (5 + 1 + 3 outer iterations x 2), each re-opening its solve's
# stage; no search.
HASH_STEP_MARKS = {"lidar_front": 1, "solve": 1 + 4 + 12, "hash_build": 6,
                   "hash_query": 18, "map_refine": 1 + 2 + 6,
                   "map_update": 1}
HASH_MARKS = dict(HASH_STEP_MARKS, carry=1, end=1)
STAGE_METRICS = [f"stage.{s}_ms.replay" for s in (
    "lidar_front", "vision_front", "search", "solve", "map_refine",
    "map_update", "vision_book", "carry", "outside", "hash_build",
    "hash_query")]
NEW_METRICS = STAGE_METRICS + ["graphs.launch_ms.replay",
                               "hash_search_roofline"]
VISION_ONLY = {"stage.vision_front_ms.replay", "stage.vision_book_ms.replay"}
HASH_ONLY = {"stage.hash_build_ms.replay", "stage.hash_query_ms.replay",
             "hash_search_roofline"}
DENSE_ONLY = {"stage.search_ms.replay"}


@pytest.fixture
def fake_capture(monkeypatch):
    """A capture in progress, with the marks it would enqueue listed."""
    marks = []
    monkeypatch.setattr(profiling, "capturing", lambda: True)
    monkeypatch.setattr(profiling, "launch_mark", marks.append)
    return marks


def test_stage_marks_in_a_capture(fake_capture):
    with profiling.stage("lidar_front"):
        pass
    with profiling.stage("solve"):
        with profiling.stage("search"):
            pass
        with profiling.stage("search"):
            pass
    with profiling.stage("map_refine"):
        with profiling.stage("search"):
            pass
    with profiling.stage("carry"):
        pass
    profiling.stage_end()
    assert fake_capture == ["lidar_front", "solve", "search", "solve",
                            "search", "solve", "map_refine", "search",
                            "map_refine", "carry", "end"]
    assert profiling._open == []


def test_a_failed_stage_marks_nothing_more(fake_capture):
    with pytest.raises(ValueError):
        with profiling.stage("solve"):
            with profiling.stage("search"):
                raise ValueError("capture refused")
    assert fake_capture == ["solve", "search"]
    assert profiling._open == []


def _host_names(prof) -> list:
    return [ev.name for ev in prof.events()]


def test_stage_outside_a_capture_is_a_profiler_range(monkeypatch):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert profiling.profiler_active()
        with profiling.stage("solve"):
            with profiling.stage("search"):
                torch.ones(3) + 1
    names = _host_names(prof)
    assert names.count("velo.stage.solve") == 1
    assert names.count("velo.stage.search") == 1

    def refused(name):
        raise AssertionError(f"range {name} opened without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    assert not profiling.profiler_active()
    with profiling.stage("solve"), profiling.span("velo.graphs.launch"):
        pass
    profiling.stage_end()  # no capture: nothing to enqueue


def test_mark_names_are_clear_of_the_readers_kernel_names():
    kernels = [profiling.MARK_PREFIX + m for m in profiling.MARKS]
    for kernel in kernels:
        for taken in (harness.MARKER, "dist_topk", "klt_l0"):
            assert taken not in kernel
        assert _stages.MARK.fullmatch(kernel)
    # A host range named like a kernel would make the harness read that
    # kernel as the range's device-side annotation.
    ranges = {f"velo.stage.{s}" for s in profiling.STAGES}
    assert not ranges & set(kernels)
    assert profiling.MARKS[-1] == "end"
    assert len(set(profiling.MARKS)) == len(profiling.MARKS)


def test_marks_are_the_kernels_of_stage_mark_cu():
    src = (ROOT / "velo_tpu_torch" / "csrc" / "stage_mark.cu").read_text()
    defined = re.findall(r'extern "C" __global__ void velo_stage_(\w+)\(\)',
                         src)
    table = re.search(r"kMarks\[\]\)\(\) = \{(.*?)\};", src, re.S).group(1)
    listed = re.findall(r"velo_stage_(\w+)", table)
    assert defined == listed == list(profiling.MARKS)


def _lidar_config(engine="dense"):
    base = config.tiny_test_config()
    return dataclasses.replace(
        base, use_vision=False, use_map=True, prebin_host=True,
        lidar=dataclasses.replace(base.lidar, n_rings=16, n_azimuth=256),
        solver=dataclasses.replace(base.solver, nn_engine=engine),
        map=dataclasses.replace(base.map, map_every=1, maintain_every=2))


@pytest.fixture(scope="module")
def lidar_drive():
    """(config, grids (F, 16, 256, 5), masks (F, 16, 256)) of 4 sweeps."""
    cfg = _lidar_config()
    fx = fixtures.make_fixture(n_frames=4, n_rings=16, n_azimuth=256,
                               with_images=False, seed=3)
    binned = [rangeimage.bin_scan_host(s, cfg.lidar) for s in fx.scans]
    return (cfg, torch.from_numpy(np.stack([g for g, _ in binned])),
            torch.from_numpy(np.stack([m for _, m in binned])))


def test_eager_step_opens_each_stage_on_the_cpu(lidar_drive):
    cfg, grids, masks = lidar_drive
    carry = odometry.init_carry(cfg, "cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        odometry.step(carry, grids[0], masks[0], cfg)
    found = collections.Counter(
        n[len("velo.stage."):] for n in _host_names(prof)
        if n.startswith("velo.stage."))
    assert found == {"lidar_front": 1, "solve": 1, "search": 4,
                     "map_refine": 1, "map_update": 1}


def test_hash_step_marks_each_build_and_query(fake_capture, lidar_drive):
    _, grids, masks = lidar_drive
    cfg = _lidar_config("hash")
    carry = odometry.init_carry(cfg, "cpu")
    odometry.step(carry, grids[1], masks[1], cfg)
    assert collections.Counter(fake_capture) == HASH_STEP_MARKS
    # Each build and query nests in its solve's stage, whose mark follows.
    outer = None
    for mark, after in zip(fake_capture, fake_capture[1:]):
        if mark.startswith("hash_"):
            assert after == outer in ("solve", "map_refine"), fake_capture
        else:
            outer = mark
    assert profiling._open == []


class _Carry(NamedTuple):
    x: torch.Tensor
    frame_host: int


class _FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def _launches() -> int:
    return profiling.counters().get("graphs.launch", (0, 0.0))[0]


def test_launch_counter_skips_profiled_replays_and_survives_release():
    step = graphs.CapturedStep("fake", fn=None, cadence=lambda fh: ())
    graph, result = _FakeGraph(), torch.zeros(2)
    step._graphs[()] = (graph, result)
    carry = _Carry(torch.ones(3), 0)
    before = _launches()
    for _ in range(3):
        carry, out = step(carry, torch.ones(2))
    assert carry.frame_host == 3 and out is not result
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        carry, _ = step(carry, torch.ones(2))
    assert graph.replays == 4
    assert _launches() == before + 3  # the profiled replay not counted
    names = _host_names(prof)
    for span in ("velo.graphs.copy_in", "velo.graphs.launch",
                 "velo.graphs.result"):
        assert names.count(span) == 1, span
    n, seconds = profiling.counters()["graphs.launch"]
    graphs.release()
    assert profiling.counters()["graphs.launch"] == (n, seconds)
    assert seconds >= 0.0


def test_bin_scan_host_span_leaves_the_grid_unchanged():
    cfg = _lidar_config().lidar
    scan = fixtures.make_fixture(n_frames=1, n_rings=16, n_azimuth=256,
                                 with_images=False, seed=5).scans[0]
    plain = rangeimage.bin_scan_host(scan, cfg)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        spanned = rangeimage.bin_scan_host(scan, cfg)
    assert _host_names(prof).count("velo.bin_scan_host") == 1
    for a, b in zip(plain, spanned):
        assert np.array_equal(a, b)


# ------------------------------------------------- the benchmark's readers


def _frame(t, vision: bool, engine: str = "dense"):
    """Device events (name, start ns, duration ns) of one replayed frame
    from ``t``: the copy-in, the captured step with its marks, the result's
    copy; and {stage: ns} of its operations.  ``engine="hash"``: a grid
    build and a query nested in each solve in place of the searches."""
    ev, ns = [], collections.Counter()

    def op(name, d, stage):
        nonlocal t
        ev.append((name, t, d))
        ns[stage] += d
        t += d + 5

    def mark(stage):
        nonlocal t
        ev.append((f"velo_stage_{stage}", t, 2))
        t += 7

    op("Memcpy DtoD (Device -> Device)", 40, "outside")
    mark("lidar_front")
    op("vectorized_elementwise_kernel", 300, "lidar_front")
    op("Memset (Device)", 10, "lidar_front")
    if vision:
        mark("vision_front")
        op("klt_l0_kernel", 120, "vision_front")
    def searches(outer, d_search, op_name, d_op):
        for _ in range(2):
            if engine == "hash":
                mark("hash_build")
                op("radixSortKVInPlace", 70, "hash_build")
                mark(outer)
                mark("hash_query")
                op("searchsorted_cuda_kernel", d_search, "hash_query")
            else:
                mark("search")
                op("dist_topk_kernel", d_search, "search")
            mark(outer)
            op(op_name, d_op, outer)

    mark("solve")
    op("elementwise_kernel_128", 200, "solve")
    searches("solve", 90, "gemm_f64", 60)
    mark("map_refine")
    op("reduce_kernel", 80, "map_refine")
    searches("map_refine", 110, "reduce_kernel", 30)
    mark("map_update")
    op("scatter_kernel", 70, "map_update")
    if vision:
        mark("vision_book")
        op("corner_kernel", 50, "vision_book")
    mark("carry")
    op("Memcpy DtoD (Device -> Device)", 25, "carry")
    mark("end")
    op("copy_kernel", 15, "outside")
    return ev, ns, t


def _replay_run(vision: bool, frames: int = 2, marks: bool = True,
                engine: str = "dense"):
    """A replay run's trace as the harness reads it: ``frames`` frames
    between two ``harness.MARKER`` kernels, and work outside them."""
    device = [("vectorized_elementwise_kernel", 0, 50)]
    device.append((harness.MARKER, 100, 10))
    t, expect = 200, collections.Counter()
    for _ in range(frames):
        ev, ns, t = _frame(t, vision, engine)
        device += ev
        expect += ns
    device.append((harness.MARKER, t + 50, 10))
    device.append(("vectorized_elementwise_kernel", t + 100, 50))
    if not marks:
        device = [e for e in device if not e[0].startswith("velo_stage_")]
    host = [("velo.graphs.launch", 150, 400), ("cudaGraphLaunch", 160, 300)]
    # The device-side copy of a host range: not an operation of the card.
    device.append(("velo.graphs.launch", 210, 30))
    trace = harness.trace_of(device, host, 1.0, frames)
    return {"kind": "replay", "trace": trace}, expect


def _read(name, run):
    return harness.plugin("metrics", name).read(run)


def test_stage_split_of_a_synthetic_fused_trace():
    run, expect = _replay_run(vision=True, frames=2)
    split = _stages.split_ms(run)
    want = {k: v * 1e-6 / 2 for k, v in expect.items()}
    assert split.keys() == want.keys()
    for stage, ms in want.items():
        assert split[stage] == pytest.approx(ms, rel=1e-12), stage
        assert _read(f"stage.{stage}_ms.replay", run) == pytest.approx(ms)
    ops = sum(d for n, _, d, _ in run["trace"].device
              if not n.startswith("velo_stage_"))
    assert sum(split.values()) == pytest.approx(ops * 1e-6 / 2)
    assert split["outside"] == pytest.approx((40 + 15) * 1e-6)


def test_stage_split_of_a_lidar_trace_has_no_vision_stage():
    run, expect = _replay_run(vision=False, frames=3)
    assert _read("stage.vision_front_ms.replay", run) is None
    assert _read("stage.vision_book_ms.replay", run) is None
    split = _stages.split_ms(run)
    assert set(split) == {"outside", "lidar_front", "solve", "search",
                          "map_refine", "map_update", "carry"}
    assert sum(split.values()) == pytest.approx(
        sum(expect.values()) * 1e-6 / 3)


def _bench_config(name):
    spec = harness.benchmark()
    entry = next(c for c in spec["configs"] if c["name"] == name)
    return harness.build_config(config,
                                harness.config_file(entry)["velo_config"])


def test_stage_split_and_roofline_of_a_synthetic_hash_trace():
    run, expect = _replay_run(vision=False, frames=3, engine="hash")
    run["cfg"] = _bench_config("kitti-hdl64-lidar-hash")
    split = _stages.split_ms(run)
    assert set(split) == {"outside", "lidar_front", "solve", "hash_build",
                          "hash_query", "map_refine", "map_update", "carry"}
    for stage, ns in expect.items():
        assert split[stage] == pytest.approx(ns * 1e-6 / 3), stage
    build = _read("stage.hash_build_ms.replay", run)
    query = _read("stage.hash_query_ms.replay", run)
    assert build == pytest.approx(4 * 70 * 1e-6)
    assert query == pytest.approx(2 * (90 + 110) * 1e-6)
    least_ms = 1e3 * voxel_hash.frame_least_seconds(run["cfg"])
    assert _read("hash_search_roofline", run) == pytest.approx(
        100.0 * least_ms / (build + query))
    # The count is the configuration's: 6 builds, 18 queries a frame.
    calls = voxel_hash.frame_calls(run["cfg"])
    assert sum(share for share, *_ in calls) == 6
    assert sum(share * iters for share, iters, *_ in calls) == 18
    dense, _ = _replay_run(vision=False, frames=3)
    dense["cfg"] = _bench_config("kitti-hdl64-lidar")
    assert voxel_hash.frame_calls(dense["cfg"]) == []
    for name in HASH_ONLY:
        assert _read(name, dense) is None, name


def test_stage_readers_read_nothing_without_marks():
    unmarked, _ = _replay_run(vision=True, marks=False)
    marked, _ = _replay_run(vision=True)
    for name in STAGE_METRICS + ["hash_search_roofline"]:
        assert _read(name, unmarked) is None, name
        assert _read(name, {"kind": "replay", "trace": None}) is None
        assert _read(name, dict(marked, kind="online")) is None


def test_launch_reader_reads_the_counter():
    n, seconds = profiling.counters().get("graphs.launch", (0, 0.0))
    value = _read("graphs.launch_ms.replay", {"kind": "replay"})
    assert value == (pytest.approx(1e3 * seconds / n) if n else None)
    assert _read("graphs.launch_ms.replay", {"kind": "online"}) is None


@pytest.mark.parametrize("name", NEW_METRICS)
def test_new_per_layer_entry_finds_its_reader(name):
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(m for m in spec["per_layer"] if m["name"] == name)
    assert callable(harness.plugin("metrics", name).read)
    assert entry["moves"] == "frames_per_s"
    assert entry["unit"] == ("%" if name.endswith("_roofline") else "ms")
    if name.startswith("stage."):
        assert entry["source"] == "device_trace"
        assert entry["layer"].startswith("frame loop stages")
    elif name.endswith("_roofline"):
        assert entry["source"] == "device_trace"
        assert entry["layer"].startswith("correspondence search")
    else:
        assert entry["source"] == "program_counter"
    expected = {"fused.replay": name not in HASH_ONLY,
                "lidar.replay": name not in HASH_ONLY | VISION_ONLY,
                "lidar.hash": name not in DENSE_ONLY | VISION_ONLY,
                "lidar.online": False}
    for cell, want in expected.items():
        listed = name in {m["name"] for m in harness.metrics_of(spec, cell,
                                                                True)}
        assert listed == want, cell


# ------------------------------------------------------------ on the card


@pytest.mark.cuda
@pytest.mark.parametrize("engine, marks", [("dense", LIDAR_MARKS),
                                           ("hash", HASH_MARKS)])
def test_captured_lidar_step_marks_each_stage_per_frame(lidar_drive, engine,
                                                       marks):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, grids, masks = lidar_drive
    cfg = _lidar_config(engine)
    dev = torch.device("cuda")
    grids, masks = grids.to(dev), masks.to(dev)
    graphs.release()
    carry = odometry.init_carry(cfg, dev)
    for f in range(2):  # captures both cadence keys
        carry, _ = odometry.jit_step(carry, grids[f], masks[f], cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for f in range(2, 4):
            carry, out = odometry.jit_step(carry, grids[f], masks[f], cfg)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    found = collections.Counter(
        ev.name() for ev in prof.profiler.kineto_results.events()
        if ev.device_type() == cuda
        and ev.name().startswith(profiling.MARK_PREFIX))
    assert found == {profiling.MARK_PREFIX + k: 2 * v
                     for k, v in marks.items()}
    assert torch.isfinite(out.T_w).all()
    graphs.release()
