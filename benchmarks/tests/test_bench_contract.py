"""The benchmark's files against its contract, its arithmetic, and its
imports."""
import ast
import json
import re
import shutil
import sys

import pytest

from benchmarks import harness
from benchmarks.tests.conftest import ROOT, tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_names_and_units_use_allowed_characters():
    names = [c["name"] for c in SPEC["configs"]]
    names += [w[k] for w in SPEC["workloads"]
              for k in ("name", "config", "traffic")]
    names += [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += [k for c in SPEC["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names
                                               if not NAME.match(n)]
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    for text in ([w["why"] for w in SPEC["workloads"]]
                 + [c["source"] for c in SPEC["configs"]]
                 + [m["layer"] for m in SPEC["per_layer"]]
                 + SPEC["command"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        seen = [x["name"] for x in SPEC[group]]
        assert len(seen) == len(set(seen)), group


def test_every_workload_finds_its_files_by_name():
    for w in SPEC["workloads"]:
        work, conf_entry = harness.cell(SPEC, w["name"])
        conf = harness.config_file(conf_entry)
        doc = harness.workload_file(w["name"])
        assert doc["config"] == w["config"] == conf["name"]
        assert doc["traffic"] == w["traffic"]
        traffic = harness.plugin("traffic", doc["kind"])
        assert all(hasattr(traffic, f) for f in ("prepare", "window",
                                                 "profile"))
        for trace in (False, True):
            for m in harness.metrics_of(SPEC, w["name"], trace):
                assert callable(harness.plugin("metrics", m["name"]).read)
        assert set(doc["limits"]) == {"pose_gap_m", "rot_gap_deg"}


@pytest.mark.parametrize("config", [c["name"] for c in SPEC["configs"]])
def test_config_files_spell_out_every_field(config):
    import velo_tpu_torch
    from benchmarks.reference import config as rconfig

    entry = next(c for c in SPEC["configs"] if c["name"] == config)
    doc = harness.config_file(entry)
    assert doc["source"] == entry["source"] and len(doc["source"]) <= 200
    assert doc["reduced"] == entry["reduced"]
    cfg = harness.build_config(velo_tpu_torch.config, doc["velo_config"])
    assert cfg.prebin_host and cfg.lidar.n_rings == 64
    harness.build_config(rconfig, doc["velo_config"])


@pytest.mark.parametrize("edit", ["drop", "unknown", "drop_nested"])
def test_config_missing_or_unknown_field_is_refused(edit):
    import velo_tpu_torch

    doc = harness.config_file(SPEC["configs"][0])["velo_config"]
    if edit == "drop":
        del doc["use_map"]
    elif edit == "unknown":
        doc["lidar"]["n_beams"] = 64
    else:
        del doc["solver"]["lm_iters"]
    with pytest.raises(ValueError):
        harness.build_config(velo_tpu_torch.config, doc)


def test_percentile_and_rate():
    values = [float(v) for v in range(1, 101)]
    assert harness.percentile(values, 95) == pytest.approx(95.05)
    assert harness.percentile([7.0], 95) == 7.0
    assert harness.rate(300, 30.0) == 10.0
    with pytest.raises(ValueError):
        harness.rate(1, 0.0)


def test_pose_gaps_and_compare():
    import numpy as np

    eye = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    moved = eye.copy()
    moved[2, 0, 3] = 0.01
    c, s = np.cos(np.radians(0.5)), np.sin(np.radians(0.5))
    moved[1, :2, :2] = [[c, -s], [s, c]]
    dt, dr = harness.pose_gaps(moved, eye)
    assert dt == pytest.approx([0.0, 0.0, 0.01], abs=1e-7)
    assert dr == pytest.approx([0.0, 0.5, 0.0], abs=1e-4)
    limits = {"pose_gap_m": 1e-3, "rot_gap_deg": 1e-2}
    checks, failed = harness.compare([eye, moved[:2]], eye, limits)
    assert failed == 1 and not harness.checks_pass(checks)
    checks, failed = harness.compare([eye, eye[:1]], eye, limits)
    assert failed == 0 and harness.checks_pass(checks)
    assert checks["poses_compared"]["value"] == 4
    nan = eye.copy()
    nan[0, 0, 0] = np.nan
    checks, failed = harness.compare([nan], eye, limits)
    assert failed == 2 and not harness.checks_pass(checks)


def test_busy_seconds_merges_overlaps():
    events = [("a", 0, 10, "kernel"), ("b", 5, 10, "kernel"),
              ("c", 30, 5, "gpu_memcpy")]
    assert harness.busy_seconds(events) == pytest.approx(20e-9)


@pytest.mark.parametrize("name, kind", [
    ("void at::native::vectorized_elementwise_kernel<4>(...)", "kernel"),
    ("dist_topk_kernel", "kernel"),
    ("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy"),
    ("Memset (Device)", "gpu_memset"),
    ("bench.jit_step", "gpu_user_annotation"),
])
def test_device_events_are_classified_by_name(name, kind):
    assert harness.kind_of(name, {"bench.jit_step", "cudaGraphLaunch"}) \
        == kind


def test_trace_is_read_between_the_markers():
    spin = "at::cuda::(anonymous namespace)::spin_kernel(long)"
    device = [("ramp", 0, 100), (spin, 100, 10), ("k", 105, 20),
              ("k", 130, 40), ("Memcpy DtoD", 175, 5), ("bench.x", 110, 90),
              (spin, 200, 10), ("after", 215, 50)]
    host = [("cudaGraphLaunch", 50, 100), ("bench.x", 110, 90),
            ("late", 300, 5)]
    t = harness.trace_of(device, host, 9.0, 10)
    assert t.window_s == pytest.approx(90e-9) and t.frames == 10
    assert t.device == [("k", 110, 15, "kernel"), ("k", 130, 40, "kernel"),
                        ("Memcpy DtoD", 175, 5, "gpu_memcpy")]
    assert harness.busy_seconds(t.device) == pytest.approx(60e-9)
    assert t.host == [("cudaGraphLaunch", 110, 40), ("bench.x", 110, 90)]
    # Without two markers the whole trace and the host's window count.
    whole = harness.trace_of(device[:1], host, 9.0, 10)
    assert whole.window_s == 9.0 and whole.device == [("ramp", 0, 100,
                                                       "kernel")]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    bad = {}
    for path in (ROOT / "benchmarks").rglob("*.py"):
        top = {name.split(".", 1)[0] for name in _imports(path)}
        found = top & set(harness.FORBIDDEN_MODULES)
        if found:
            bad[str(path)] = found
    assert not bad
    # Whole names: the program's name begins with the JAX package's.
    assert "velo_tpu_torch" not in harness.FORBIDDEN_MODULES
    assert [m for m in ["velo_tpu_torch", "velo_tpu_torch.fp"]
            if m.split(".", 1)[0] in harness.FORBIDDEN_MODULES] == []


def test_reference_and_drive_import_nothing_of_the_program():
    for sub in ("reference", "drive", "roofline"):
        for path in (ROOT / "benchmarks" / sub).rglob("*.py"):
            top = {name.split(".", 1)[0] for name in _imports(path)}
            assert "velo_tpu_torch" not in top, path


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "velo_tpu_torch_like", sys)
    assert "velo_tpu_torch_like" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax.numpy"]


def test_a_new_cell_and_metric_need_only_new_files(tmp_path, capsys):
    """In a copy: a new cell (an existing kind with its own parameters)
    and a new per-layer metric, added as files plus their BENCHMARK.json
    entries, run without an edit to any file that was there."""
    from benchmarks import run

    shutil.copytree(ROOT / "benchmarks", tmp_path / "benchmarks")
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p: p.read_bytes() for p in (tmp_path / "benchmarks").rglob("*")
              if p.is_file()}
    work = json.loads((tmp_path / "benchmarks/workloads/lidar.replay.json")
                      .read_text())
    work.update(name="lidar.replay3", traffic="replay3")
    work["params"]["chunk_frames"] = 3
    (tmp_path / "benchmarks/workloads/lidar.replay3.json").write_text(
        json.dumps(work))
    (tmp_path / "benchmarks/metrics/frames_done.py").write_text(
        "def read(run):\n    return run['frames']\n")
    spec["workloads"].append({"name": "lidar.replay3",
                              "config": "kitti-hdl64-lidar",
                              "traffic": "replay3", "chips": 1, "why": "x"})
    spec["per_layer"].append({"name": "frames_done", "unit": "frames",
                              "better": "higher", "source": "host_clock",
                              "layer": "x", "moves": "frames_per_s",
                              "workloads": ["lidar.replay3"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    rc = run.main(["--workload", "lidar.replay3", "--seed", "3", "--seconds",
                   "0.5", "--trace", "1"], device="cpu", adjust=tiny,
                  root=tmp_path)
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and out["correct"]
    assert out["metrics"]["frames_done"]["value"] == out["attempted"]
    after = {p: p.read_bytes() for p in before}
    assert after == before
